// Tile march of the TSDF grid: hit depth per ray.
//
// Replaces open3d_tpu/ops/pallas/raycast.py:_march_kernel and computes its
// function: for each 16x16-pixel tile, walk the tile's candidate blocks,
// extras first, then the front-to-back list. Per ray and block: the chord
// [t_in, t_out] clipped to [depth_min, depth_max] (1e-9 guard on the ray
// direction); M samples at t_in + (m + 0.5) step at the snapped voxel,
// where an unallocated voxel reads 2.0 and an unusable sample reads 1.0;
// the voxel-centre ray parameter; +/- crossing detection with the carry of
// the previous block's last sample, used only when contiguous along the
// ray; the crossing interpolated between voxel-centre parameters and
// clamped to the sample bracket; the minimum hit kept. A tile stops once
// every one of its 256 rays (in the image or not) has a hit: the result
// depends on that break, so it is kept. A miss writes 0.
//
// Design: one CTA per tile, one thread per ray, and no barrier per block.
// The tile's candidate list (row and block coordinates, extras first) is
// staged in shared memory once. Then each thread walks the candidates on
// its own (phase A): it computes its chord and, if its ray meets the block,
// the M sample positions and their voxel indices, and issues the M loads of
// the sampled payload words (read-only path) before it uses any of them.
// Sample addresses depend on geometry only, so the next block the ray
// meets is found and its loads issued before the current block's samples
// are consumed. Only the sampled words are decoded; the crossing logic and
// its carry (previous value and parameter, contiguity) stay in registers.
//
// The break. The JAX kernel stops a tile after the first step k* at which
// every ray has a hit, so k* = max over the rays of k_first, the step of a
// ray's first hit (nk_tot - 1 for a ray that never hits). A ray reports
// k_first to the CTA (shared atomics) and walks on: a step at or below the
// largest k_first reported so far lies below k*; a step above it is
// speculative, and the one speculative step that lowers the ray's hit is
// kept with the hit before it. Once all 256 rays have reported, k* is
// known: a ray stops past it, and a hit lowered past it is put back. A
// second speculative lowering is undone (hit and carry) and the ray stops
// there; after the one barrier, rays that stopped short of k* walk on to
// it (phase B). A block a ray does not meet leaves it unchanged, so the
// result is the earlier schedule's, bit for bit, while a tile whose rays
// never all hit walks its candidates once, not once per phase.
//
// The step is a chain of dependent instructions, so its length sets both
// the throughput and the tiles that walk every candidate. Three things
// shorten it. The divisions by a per-ray value (the three slab chords'
// direction components, |d|^2 of the voxel-centre parameter) are float64
// products with a per-ray reciprocal, exact to the bit (see Ray), without
// the branch of a float32 division. The slab faces' numerators, the same
// for every ray, are staged with the candidate list (see Faces). And only
// a block's first crossing is interpolated, found with selects (see
// consume).
//
// Bound: the larger of bytes and float32 operations. The function reads
// only the payload words its samples touch before the break: the distinct
// 32-byte sectors of those samples (most served by L1 and L2, since
// neighbouring rays and tiles share voxels), the candidate entries walked,
// and 4 bytes a ray written; march_tiles_plain's stats count them. Its
// operations are the ray directions, the chords of every (tile, block)
// step, the samples of every ray that meets a block and the interpolation
// of every crossing. chip_smoke.py counts both on the bench frame (and,
// beside them, the bytes of whole 16 KiB rows, which the function does not
// read).
//
// Multiply-adds are fused (fmaf) exactly where XLA's CPU backend fuses them
// in the interpreted JAX kernel, the reference of the CPU tests; the file is
// built with --fmad=false so no other product is fused. With floor and the
// float-to-int conversions as in the plain PyTorch version, which fuses at
// the same places, the two agree to the last bit on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kRays = kTile * kTile;
constexpr int kB = 16;
constexpr int kB3 = kB * kB * kB;
constexpr int kMaxM = 16;
constexpr int kMaxCand = 256;  // candidates staged in shared memory; later ones come from global
constexpr float kBig = 1e9f;
constexpr float kSentinel = 2.0f;

struct MarchArgs {
  const int32_t* tw;
  const int32_t* rows;
  const int32_t* coords;
  const int32_t* nk;
  const int32_t* n_extra;
  const float* params;
  float* out;
  int TW, H, W, K, TK;
  float cx, cy, inv_fx, inv_fy, voxel_size, block_size, inv_vs, half_vs, two_vs, inv_m,
      depth_min, depth_max;
};

// A ray o + t d, with the float64 reciprocals of its guarded direction
// components and of |d|^2: RN32(RN64(x * RN64(1 / y))) = RN32(x / y) for
// float32 x and y, since the float64 product is within 2^-52 of x / y and
// a float32 quotient is never nearer than 2^-49 (relative) to a rounding
// midpoint. So each division by a per-ray value is a multiply, exact to the
// bit, with no slow-path branch.
struct Ray {
  float dX, dY, dZ, oX, oY, oZ;
  double rX, rY, rZ, rd2;
};

__device__ __forceinline__ float div_by(float x, double r) {
  return static_cast<float>(static_cast<double>(x) * r);
}

// 1 / the ray direction component as the chord divides by it (1e-9 guard)
__device__ __forceinline__ double guarded_rcp(float d) {
  return 1.0 / static_cast<double>(fabsf(d) > 1e-9f ? d : 1e-9f);
}

// One candidate block as one ray samples it: the chord, the block's first
// voxel, and per sample the flat voxel index (-1 outside the block) and the
// raw payload word loaded from there.
template <int M>
struct Probe {
  float t_in, step;
  int bxi, byi, bzi;
  int flat[M];
  int32_t w[M];
};

// Candidate k of tile t: (payload row, block x, y, z).
__device__ __forceinline__ int4 load_cand(const MarchArgs& a, int t, int nex, int k) {
  const int idx = k < nex ? a.TK + k : t * a.K + (k - nex);
  return make_int4(a.rows[idx], a.coords[3 * idx + 0], a.coords[3 * idx + 1],
                   a.coords[3 * idx + 2]);
}

// The six slab-face numerators of a candidate block, b bs - o and
// b bs + bs - o on each axis (o the camera origin): the same for every ray
// of the tile, so staged once, as float64.
struct Faces {
  double n[6];
};

__device__ __forceinline__ Faces faces_of(const MarchArgs& a, int4 c) {
  Faces f;
  const float o[3] = {a.params[9], a.params[10], a.params[11]};
  const float b[3] = {static_cast<float>(c.y), static_cast<float>(c.z), static_cast<float>(c.w)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.n[2 * i] = static_cast<double>(fmaf(b[i], a.block_size, -o[i]));
    f.n[2 * i + 1] = static_cast<double>(fmaf(b[i], a.block_size, a.block_size) - o[i]);
  }
  return f;
}

// The chord of one axis's slab: its faces' numerators over the ray's
// guarded direction component (r its reciprocal).
__device__ __forceinline__ void slab(double n0, double n1, double r, float* t0, float* t1) {
  const float p = static_cast<float>(n0 * r);
  const float q = static_cast<float>(n1 * r);
  *t0 = fminf(p, q);
  *t1 = fmaxf(p, q);
}

// The first candidate in [k, kend) that the ray meets: fills p with its
// chord, sample indices and the issued loads of its sampled words, and
// returns its index; kend if there is none.
template <int M>
__device__ __forceinline__ int seek(const MarchArgs& a, const int4* s_cand, const Faces* s_faces,
                                    int t, int nex, const Ray& ray, int k, int kend, Probe<M>& p) {
  int4 c = make_int4(0, 0, 0, 0);
  float t_in = 0.0f, t_out = 0.0f;
  for (; k < kend; ++k) {
    c = k < kMaxCand ? s_cand[k] : load_cand(a, t, nex, k);
    const Faces f = k < kMaxCand ? s_faces[k] : faces_of(a, c);
    float ax0, ax1, ay0, ay1, az0, az1;
    slab(f.n[0], f.n[1], ray.rX, &ax0, &ax1);
    slab(f.n[2], f.n[3], ray.rY, &ay0, &ay1);
    slab(f.n[4], f.n[5], ray.rZ, &az0, &az1);
    t_in = fmaxf(fmaxf(ax0, ay0), fmaxf(az0, a.depth_min));
    t_out = fminf(fminf(ax1, ay1), fminf(az1, a.depth_max));
    if (t_out > t_in) break;
  }
  // the samples after the chord loop, so that the lanes of a warp that
  // found their blocks at different candidates compute them together
  if (k < kend) {
    p.t_in = t_in;
    p.step = (t_out - t_in) * a.inv_m;
    p.bxi = c.y * kB;
    p.byi = c.z * kB;
    p.bzi = c.w * kB;
    const int32_t* row = a.tw + static_cast<int64_t>(c.x) * kB3;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float zm = fmaf(static_cast<float>(m) + 0.5f, p.step, p.t_in);
      const int lx = static_cast<int>(floorf(fmaf(ray.dX, zm, ray.oX) * a.inv_vs)) - p.bxi;
      const int ly = static_cast<int>(floorf(fmaf(ray.dY, zm, ray.oY) * a.inv_vs)) - p.byi;
      const int lz = static_cast<int>(floorf(fmaf(ray.dZ, zm, ray.oZ) * a.inv_vs)) - p.bzi;
      const bool inb = lx >= 0 && lx < kB && ly >= 0 && ly < kB && lz >= 0 && lz < kB;
      p.flat[m] = inb ? lx + ly * kB + lz * kB * kB : -1;
      p.w[m] = inb ? __ldg(row + p.flat[m]) : 0;
    }
  }
  return k;
}

// The ray parameter of the centre of voxel f of the probe's block.
template <int M>
__device__ __forceinline__ float voxel_param(const MarchArgs& a, const Ray& ray,
                                             const Probe<M>& p, int f) {
  const float cxw = fmaf(static_cast<float>(p.bxi + (f & 15)), a.voxel_size, a.half_vs);
  const float cyw = fmaf(static_cast<float>(p.byi + ((f >> 4) & 15)), a.voxel_size, a.half_vs);
  const float czw = fmaf(static_cast<float>(p.bzi + (f >> 8)), a.voxel_size, a.half_vs);
  return div_by(fmaf(czw - ray.oZ, ray.dZ, fmaf(cxw - ray.oX, ray.dX, (cyw - ray.oY) * ray.dY)),
                ray.rd2);
}

// The samples of one block that the ray meets, with the carry (pv, pz) of
// the previous block's last sample; keeps the nearest crossing in zhit.
// Only the block's first crossing is interpolated: a crossing at sample m
// lies in [zm(m-1), zm(m)] and zm does not decrease with m, so a later one
// is never nearer, and the minimum over all of them (the JAX kernel's) is
// the first. The sample loop finds it with selects, no branch; the
// voxel-centre parameters it needs (samples m and m - 1) are computed once.
template <int M>
__device__ __forceinline__ void consume(const MarchArgs& a, const Ray& ray, const Probe<M>& p,
                                        float& zhit, float& pv, float& pz) {
  const bool contig = fabsf(p.t_in - pz) <= fmaxf(p.step, a.two_vs);
  float vprev = contig ? pv : 1.0f;
  float zprev = contig ? pz : p.t_in;
  float zm = 0.0f, val = 0.0f;
  bool ok = false, found = false;
  // the first crossing's bracket: values, parameters, and the flat indices
  // of its sample and of the sample before (-1: outside the block, or the carry)
  float c_vprev = 0.0f, c_v = 0.0f, c_zprev = 0.0f, c_zm = 0.0f;
  int c_f = 0, c_fprev = -1;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    zm = fmaf(static_cast<float>(m) + 0.5f, p.step, p.t_in);
    const int32_t w = p.w[m];
    val = (w & 0xFFFF) > 0 ? static_cast<float>(w >> 16) * (1.0f / 16383.0f) : kSentinel;
    ok = (p.flat[m] >= 0) && (val < 1.5f);
    const float v_eff = ok ? val : 1.0f;
    const bool first = !found && (vprev > 0.0f) && (v_eff <= 0.0f) && ok && (zm > zprev);
    c_vprev = first ? vprev : c_vprev;
    c_v = first ? v_eff : c_v;
    c_zprev = first ? zprev : c_zprev;
    c_zm = first ? zm : c_zm;
    c_f = first ? p.flat[m] : c_f;
    if (m > 0) c_fprev = first ? p.flat[m > 0 ? m - 1 : 0] : c_fprev;
    found = found || first;
    vprev = v_eff;
    zprev = zm;
  }
  if (found) {
    // zvprev: the voxel-centre parameter of the sample before, or its sample
    // parameter when it lies outside the block, or the carried parameter
    const float zv = voxel_param(a, ray, p, c_f);
    const float zvprev = c_fprev >= 0 ? voxel_param(a, ray, p, c_fprev) : c_zprev;
    float zc = fmaf(c_vprev / fmaxf(c_vprev - c_v, 1e-6f), zv - zvprev, zvprev);
    zc = fminf(fmaxf(zc, fminf(c_zprev, c_zm)), fmaxf(c_zprev, c_zm));
    zhit = fminf(zhit, fminf(kBig, zc));
  }
  pv = ok ? val : 1.0f;
  pz = fmaxf(zm, pz);
}

template <int M>
__global__ void __launch_bounds__(kRays) march_kernel(const MarchArgs a) {
  __shared__ int4 s_cand[kMaxCand];
  __shared__ Faces s_faces[kMaxCand];
  __shared__ int s_kmax;   // the largest first-hit candidate reported (k* once all have)
  __shared__ int s_count;  // rays that have reported

  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int nex = a.n_extra[0];
  const int nk_tot = a.nk[t] + nex;
  for (int i = r; i < min(nk_tot, kMaxCand); i += kRays) {
    s_cand[i] = load_cand(a, t, nex, i);
    s_faces[i] = faces_of(a, s_cand[i]);
  }
  if (r == 0) {
    s_kmax = -1;
    s_count = 0;
  }

  const int u = (t % a.TW) * kTile + r % kTile;
  const int v = (t / a.TW) * kTile + r / kTile;
  const float x = (static_cast<float>(u) - a.cx) * a.inv_fx;
  const float y = (static_cast<float>(v) - a.cy) * a.inv_fy;
  const float* P = a.params;
  Ray ray;
  ray.dX = fmaf(P[0], x, P[1] * y) + P[2];
  ray.dY = fmaf(P[3], x, P[4] * y) + P[5];
  ray.dZ = fmaf(P[6], x, P[7] * y) + P[8];
  ray.oX = P[9];
  ray.oY = P[10];
  ray.oZ = P[11];
  ray.rX = guarded_rcp(ray.dX);
  ray.rY = guarded_rcp(ray.dY);
  ray.rZ = guarded_rcp(ray.dZ);
  ray.rd2 = 1.0 / static_cast<double>(
                      fmaxf(fmaf(ray.dZ, ray.dZ, fmaf(ray.dX, ray.dX, ray.dY * ray.dY)), 1e-12f));
  __syncthreads();

  float zhit = kBig, pv = 1.0f, pz = 0.0f;
  Probe<M> cur, nxt;

  // Phase A: walk to this ray's first hit and report it; then walk on
  // while the tile's break k* is not known. A step at or below the largest
  // first hit reported so far is at or below k*; a step above it is
  // speculative, and the one speculative lowering of the hit is kept with
  // the hit before it (a second is undone, and the ray waits for phase B).
  int kc = seek(a, s_cand, s_faces, t, nex, ray, 0, nk_tot, cur);
  bool hit = false;
  int spec_k = -1;      // the speculative step that lowered the hit, if any
  float spec_z = kBig;  // the hit before it
  while (kc < nk_tot) {
    bool safe = !hit;
    if (hit) {
      const int kmax = *reinterpret_cast<volatile int*>(&s_kmax);
      if (*reinterpret_cast<volatile int*>(&s_count) == kRays && kc > kmax) break;
      safe = kc <= kmax;
    }
    const int kn = seek(a, s_cand, s_faces, t, nex, ray, kc + 1, nk_tot, nxt);
    const float z0 = zhit, pv0 = pv, pz0 = pz;
    consume(a, ray, cur, zhit, pv, pz);
    if (!hit && zhit < kBig) {
      hit = true;
      atomicMax(&s_kmax, kc);
      __threadfence_block();
      atomicAdd(&s_count, 1);
    } else if (!safe && zhit < z0) {
      if (spec_k >= 0) {
        zhit = z0;
        pv = pv0;
        pz = pz0;
        break;
      }
      spec_k = kc;
      spec_z = z0;
    }
    cur = nxt;
    kc = kn;
  }
  if (!hit) {  // walked every candidate: k_first = nk_tot - 1
    atomicMax(&s_kmax, nk_tot - 1);
    __threadfence_block();
    atomicAdd(&s_count, 1);
  }

  // The break: the tile stops after step k* = max over its rays of k_first.
  __syncthreads();
  const int kstar = s_kmax;
  if (spec_k > kstar) zhit = spec_z;  // that change came after the break

  // Phase B: rays that hit before k* walk on to it with their carry.
  while (kc <= kstar) {
    const int kn = seek(a, s_cand, s_faces, t, nex, ray, kc + 1, kstar + 1, nxt);
    consume(a, ray, cur, zhit, pv, pz);
    cur = nxt;
    kc = kn;
  }
  if (u < a.W && v < a.H) a.out[v * a.W + u] = zhit < kBig ? zhit : 0.0f;
}

// One instantiation a sample count: the M loads of a block stay in registers.
template <int M>
cudaError_t launch(const MarchArgs& a, int T, cudaStream_t s) {
  march_kernel<M><<<T, kRays, 0, s>>>(a);
  return cudaGetLastError();
}

// out[0] <- CTAs a multiprocessor, out[3] <- registers a thread.
template <int M>
cudaError_t occupancy(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, march_kernel<M>);
  if (err != cudaSuccess) return err;
  out[3] = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], march_kernel<M>, kRays, 0);
}

using LaunchFn = cudaError_t (*)(const MarchArgs&, int, cudaStream_t);
using OccupancyFn = cudaError_t (*)(int*);
constexpr LaunchFn kLaunch[kMaxM] = {
    launch<1>, launch<2>, launch<3>, launch<4>, launch<5>, launch<6>, launch<7>, launch<8>,
    launch<9>, launch<10>, launch<11>, launch<12>, launch<13>, launch<14>, launch<15>, launch<16>};
constexpr OccupancyFn kOccupancy[kMaxM] = {
    occupancy<1>, occupancy<2>, occupancy<3>, occupancy<4>, occupancy<5>, occupancy<6>,
    occupancy<7>, occupancy<8>, occupancy<9>, occupancy<10>, occupancy<11>, occupancy<12>,
    occupancy<13>, occupancy<14>, occupancy<15>, occupancy<16>};

}  // namespace

extern "C" int o3dt_march_tiles(
    const void* tw, const void* rows, const void* coords, const void* nk,
    const void* n_extra, const void* params, void* out, int T, int TW, int H,
    int W, int K, int M, float cx, float cy, float inv_fx, float inv_fy,
    float voxel_size, float block_size, float inv_vs, float half_vs,
    float two_vs, float inv_m, float depth_min, float depth_max, void* stream) {
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  const MarchArgs a{static_cast<const int32_t*>(tw), static_cast<const int32_t*>(rows),
                    static_cast<const int32_t*>(coords), static_cast<const int32_t*>(nk),
                    static_cast<const int32_t*>(n_extra), static_cast<const float*>(params),
                    static_cast<float*>(out), TW, H, W, K, T * K, cx, cy, inv_fx, inv_fy,
                    voxel_size, block_size, inv_vs, half_vs, two_vs, inv_m, depth_min,
                    depth_max};
  return static_cast<int>(kLaunch[M - 1](a, T, static_cast<cudaStream_t>(stream)));
}

// The march for M samples: out[0] CTAs that one multiprocessor holds at
// once, out[1] the count of multiprocessors, out[2] threads a CTA, out[3]
// registers a thread.
extern "C" int o3dt_march_occupancy(int M, int* out) {
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  out[2] = kRays;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = kOccupancy[M - 1](out);
  return static_cast<int>(err);
}
