// In-place weighted-mean fuse of precomputed voxel samples into the rows of
// a TSDF voxel block grid.
//
// Replaces open3d_tpu/ops/pallas/tsdf.py:_fuse_kernel_color and
// _fuse_kernel_nocolor (via fuse_blocks) and computes their function: per
// voxel of each work-list row, the running weighted mean of the s1.14 tsdf
// (and of the R11|G11|B10 colour) with the new sample, the weight sum
// clamped at weight_max, the tsdf repacked with round-half-to-even and the
// colour with +0.5 and truncation. The colour variant multiplies by
// inv = 1 / max(w_sum, 1e-6); the no-colour variant divides.
//
// Bound: bytes. A live row reads three 4-byte samples and two 4-byte words a
// voxel and writes the two words back: 28 B a voxel with colour, against
// ~30 float32 operations. Each word is read once and written once; nothing
// is staged. At the fragment workload (a 4096-entry work list of which ~400
// entries are live, at the front, 8^3 blocks) that is ~5.7 MB: too little
// to fill the card, so the time is the launch, the round trip to read the
// work list, and the ~1 us the card's L2 takes to serve the live rows.
//
// Design: CTA b scans kScan entries, b + k * G for k < kScan (G CTAs: 512
// for 4096 entries), so the live run at the front of the list spreads one
// entry a CTA; in every warp lane k reads rows[b + k * G], and a ballot
// keeps the entries that are not the dump row C (the caller re-zeroes row
// C). A CTA whose entries are all dump rows exits after that one load. The
// live entries' 16-byte groups of 4 consecutive voxels (128 a row of 8^3)
// are then the CTA's tasks: a thread takes kGroups of them and issues all
// five 16-byte loads of each (tw, colour, tsdf_new, wn, cnew) before it uses
// any, then computes and writes each group back with two 16-byte stores. So
// a live voxel waits for two round trips, rows[] and the burst, and a
// live row's arithmetic spreads over the CTA's 128 threads. Any B^3 works:
// rows of B^3 % 4 == 0 voxels go as 16-byte groups (the wrapper checks that
// every row base is 16-byte aligned), the other sizes (odd B) take the same
// kernel with one voxel a group.
//
// Other layouts of this kernel were timed on the card and are slower: one
// CTA an entry (which pays for the ~3700 empty CTAs, as the one-CTA-an-entry
// design this replaced did), one warp an entry (a row's arithmetic on 32
// threads) and wider CTAs; PERF.md records what they took.
//
// Arithmetic follows the JAX kernels' order element by element. XLA's CPU
// backend, which runs the interpreted kernels that the CPU tests hold the
// port to, fuses no multiply-add there, so neither does this file: it is
// built with --fmad=false and calls no fmaf. It agrees bit for bit with
// fuse_blocks_plain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kScan = 8;    // work-list entries a CTA scans
constexpr int kGroups = 2;  // groups (tasks) a thread loads in one burst
constexpr float kTsdfScale = 16383.0f;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int32_t pack_rgb(float r, float g, float b) {
  // +0.5 then truncate, as the JAX kernel's _pack_rgb (not pack_rgb's round)
  const int ri = static_cast<int>(clipf(r * 2047.0f + 0.5f, 0.0f, 2047.0f));
  const int gi = static_cast<int>(clipf(g * 2047.0f + 0.5f, 0.0f, 2047.0f));
  const int bi = static_cast<int>(clipf(b * 1023.0f + 0.5f, 0.0f, 1023.0f));
  return (ri << 21) | (gi << 10) | bi;
}

// One group of kV consecutive 4-byte words, moved as one access.
template <int kV>
struct Group;

template <>
struct Group<4> {
  int32_t i[4];
  __device__ __forceinline__ void load(const int32_t* p) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    i[0] = v.x, i[1] = v.y, i[2] = v.z, i[3] = v.w;
  }
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    i[0] = __float_as_int(v.x), i[1] = __float_as_int(v.y);
    i[2] = __float_as_int(v.z), i[3] = __float_as_int(v.w);
  }
  __device__ __forceinline__ void store(int32_t* p) const {
    *reinterpret_cast<int4*>(p) = make_int4(i[0], i[1], i[2], i[3]);
  }
};

template <>
struct Group<1> {
  int32_t i[1];
  __device__ __forceinline__ void load(const int32_t* p) { i[0] = *p; }
  __device__ __forceinline__ void load(const float* p) { i[0] = __float_as_int(*p); }
  __device__ __forceinline__ void store(int32_t* p) const { *p = i[0]; }
};

// One voxel: the old tw (and colour) word and the new samples in, the new
// word(s) out.
template <bool kColor>
__device__ __forceinline__ void fuse_voxel(int32_t old, int32_t oc, float t_new, float w_n,
                                           int32_t nc, float weight_max, int32_t& tw_out,
                                           int32_t& col_out) {
  const float old_t = static_cast<float>(old >> 16) * (1.0f / kTsdfScale);
  const float old_w = static_cast<float>(old & 0xFFFF);
  const float w_sum = old_w + w_n;
  const bool upd = w_n > 0.0f;
  const float num = old_t * old_w + t_new * w_n;
  float t2;
  float inv = 0.0f;
  if (kColor) {
    inv = 1.0f / fmaxf(w_sum, 1e-6f);
    t2 = upd ? num * inv : old_t;
  } else {
    t2 = upd ? num / fmaxf(w_sum, 1e-6f) : old_t;
  }
  const float w2 = fminf(w_sum, weight_max);
  const int tq = __float2int_rn(clipf(t2, -1.0f, 1.0f) * kTsdfScale);
  tw_out = static_cast<int32_t>((static_cast<uint32_t>(tq) << 16) |
                                static_cast<uint32_t>(static_cast<int32_t>(w2)));
  if (kColor) {
    const float ro = static_cast<float>((oc >> 21) & 0x7FF) * (1.0f / 2047.0f);
    const float go = static_cast<float>((oc >> 10) & 0x7FF) * (1.0f / 2047.0f);
    const float bo = static_cast<float>(oc & 0x3FF) * (1.0f / 1023.0f);
    const float rn = static_cast<float>((nc >> 21) & 0x7FF) * (1.0f / 2047.0f);
    const float gn = static_cast<float>((nc >> 10) & 0x7FF) * (1.0f / 2047.0f);
    const float bn = static_cast<float>(nc & 0x3FF) * (1.0f / 1023.0f);
    const float r2 = upd ? (ro * old_w + rn * w_n) * inv : ro;
    const float g2 = upd ? (go * old_w + gn * w_n) * inv : go;
    const float b2 = upd ? (bo * old_w + bn * w_n) * inv : bo;
    col_out = pack_rgb(r2, g2, b2);
  }
}

// Position of the n-th (from 0) set bit of m; m has more than n set bits.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
  for (int step = 16; step > 0; step >>= 1) {
    const int c = __popc(m & ((1u << step) - 1));
    if (c <= n) {
      n -= c;
      m >>= step;
      pos += step;
    }
  }
  return pos;
}

// Task t of a CTA is group t % n_groups of its (t / n_groups)-th live
// entry; a round gives each thread kGroups tasks. kV voxels a group: 4 when
// B^3 % 4 == 0, else 1.
template <bool kColor, int kV>
__global__ void __launch_bounds__(kThreads) fuse_kernel(
    int32_t* __restrict__ tw, int32_t* __restrict__ color,
    const int32_t* __restrict__ rows, const float* __restrict__ tsdf_new,
    const float* __restrict__ wn, const int32_t* __restrict__ cnew, int M, int C, int B3,
    float weight_max) {
  const int lane = threadIdx.x % 32;
  const int G = gridDim.x;
  const int my_g = blockIdx.x + lane * G;
  int my_row = C;
  if (lane < kScan && my_g < M) my_row = rows[my_g];
  const unsigned live = __ballot_sync(0xffffffffu, my_row >= 0 && my_row < C);  // dump rows: skip
  const int n_groups = B3 / kV;
  const int tasks = __popc(live) * n_groups;

  for (int round = 0; round < tasks; round += kThreads * kGroups) {
    Group<kV> otw[kGroups], ocol[kGroups], tn[kGroups], w[kGroups], cn[kGroups];
    int32_t* row_tw[kGroups];
    int32_t* row_col[kGroups];
    int f[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int t = round + j * kThreads + threadIdx.x;
      const int e = t < tasks ? t / n_groups : 0;
      const int k = nth_set_bit(live, e);
      const int row = __shfl_sync(0xffffffffu, my_row, k);
      const int64_t base = static_cast<int64_t>(blockIdx.x + k * G) * B3;
      f[j] = t < tasks ? (t - e * n_groups) * kV : -1;
      row_tw[j] = tw + static_cast<int64_t>(row) * B3;
      row_col[j] = kColor ? color + static_cast<int64_t>(row) * B3 : nullptr;
      if (f[j] >= 0) {
        otw[j].load(row_tw[j] + f[j]);
        tn[j].load(tsdf_new + base + f[j]);
        w[j].load(wn + base + f[j]);
        if (kColor) {
          ocol[j].load(row_col[j] + f[j]);
          cn[j].load(cnew + base + f[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      if (f[j] >= 0) {
        Group<kV> ntw, ncol;
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          fuse_voxel<kColor>(otw[j].i[e], kColor ? ocol[j].i[e] : 0, __int_as_float(tn[j].i[e]),
                             __int_as_float(w[j].i[e]), kColor ? cn[j].i[e] : 0, weight_max,
                             ntw.i[e], ncol.i[e]);
        }
        ntw.store(row_tw[j] + f[j]);
        if (kColor) ncol.store(row_col[j] + f[j]);
      }
    }
  }
}

template <bool kColor>
void launch(int32_t* tw, int32_t* color, const int32_t* rows, const float* tsdf_new,
            const float* wn, const int32_t* cnew, int M, int C, int B3, float weight_max,
            cudaStream_t s) {
  const int grid = (M + kScan - 1) / kScan;
  if (B3 % 4 == 0) {
    fuse_kernel<kColor, 4><<<grid, kThreads, 0, s>>>(tw, color, rows, tsdf_new, wn, cnew, M, C,
                                                     B3, weight_max);
  } else {
    fuse_kernel<kColor, 1><<<grid, kThreads, 0, s>>>(tw, color, rows, tsdf_new, wn, cnew, M, C,
                                                     B3, weight_max);
  }
}

}  // namespace

extern "C" int o3dt_fuse_blocks(void* tw, void* color, const void* rows,
                                const void* tsdf_new, const void* wn, const void* cnew,
                                int M, int C, int B3, float weight_max, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (color != nullptr) {
    launch<true>(static_cast<int32_t*>(tw), static_cast<int32_t*>(color),
                 static_cast<const int32_t*>(rows), static_cast<const float*>(tsdf_new),
                 static_cast<const float*>(wn), static_cast<const int32_t*>(cnew), M, C, B3,
                 weight_max, s);
  } else {
    launch<false>(static_cast<int32_t*>(tw), nullptr, static_cast<const int32_t*>(rows),
                  static_cast<const float*>(tsdf_new), static_cast<const float*>(wn), nullptr, M,
                  C, B3, weight_max, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// For the colour (with_color != 0) or no-colour kernel at B3 voxels a row:
// out[0] CTAs a multiprocessor, out[1] multiprocessors, out[2] threads a
// CTA, out[3] registers a thread.
extern "C" int o3dt_fuse_occupancy(int with_color, int B3, int* out) {
  void (*kernel)(int32_t*, int32_t*, const int32_t*, const float*, const float*, const int32_t*,
                 int, int, int, float) =
      with_color ? (B3 % 4 == 0 ? fuse_kernel<true, 4> : fuse_kernel<true, 1>)
                 : (B3 % 4 == 0 ? fuse_kernel<false, 4> : fuse_kernel<false, 1>);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  out[2] = kThreads;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[3] = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, 0));
}
