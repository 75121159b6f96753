// One point-to-plane Gauss-Newton iteration of the dense odometry as two
// launches: the rows and their sums (sums_kernel), then the 6x6 solve, the
// exponential map and the update of the pose (solve_kernel).
//
// Replaces the eager iteration of open3d_tpu_torch/pipelines/odometry.py
// (the rows of `_rows_point_to_plane`, `Jw.T @ J`, `Jw.T @ r`,
// core/linalg.py:solve_gn_6x6 on the unrolled Cholesky, core/lie.py:se3_exp
// and the RMSE): ~300 PyTorch operations an iteration, each a launch.
//
// sums_kernel: one thread a source pixel, grid-stride over a 1-D grid of
// 256-thread CTAs, ~4 pixels a thread. A pixel is transformed by T (rows 0-2
// of the row-major 4x4), projected, associated with the nearest target pixel
// (a 24-byte row of vertex and normal), tested, weighted and turned into its
// Jacobian row J = [P x n, n]. Each thread sums 28 float32 terms (the 21 of
// the upper triangle of J^T W J, the 6 of J^T W r, r^2 over w > 0) and the
// count of valid pixels as an integer; a warp tree (shuffles) and a tree
// over the CTA's warps, both in a fixed order, reduce them, and each CTA
// writes its 29 sums into its own 32-word row of `partials`. No atomics: the
// same input gives the same bits on every run.
//
// solve_kernel: one CTA of 256 threads sums the CTAs' rows in double, in a
// fixed order (thread t takes rows t, t + 256, ..., then the same two trees),
// and its thread 0 mirrors J^T W J, damps it and solves it by the unrolled
// Cholesky of solve_gn_6x6, maps the step through se3_exp's expressions
// (the theta^2 < 1e-8 series guard and the clamp of theta^2 at 1e-16 kept),
// writes T <- exp(xi) T in place and the RMSE sqrt(sum r^2 / max(n, 1)).
// All of this runs in double and rounds to float32 once, at the writes.
//
// Rounding against the eager iteration: a pixel's operations follow
// `_rows_point_to_plane` in its order (--fmad=false: nothing fuses but the
// projection's fmaf, where the plain code calls `fma`; the division is
// IEEE's; rintf rounds half to even as torch.round does). Three orders are
// this file's own: P = ((R0 p0 + R1 p1) + R2 p2) + t, each product rounded,
// where cuBLAS's small matmul picks its own; the sums (per thread in pixel
// order, then the trees), where cuBLAS's sgemm and PyTorch's reductions
// pick theirs; and the solve and the exponential, in double where the eager
// ones run in float32. So T agrees with the eager iteration's at float32
// rounding, not bit for bit.
//
// Bound: at 640x480 sums_kernel reads the source points (12 B a pixel), their
// validity (1 B) and the gathered target rows (24 B a valid pixel): ~11 MB,
// ~3.3 us at 3.35 TB/s. solve_kernel reads ~300 rows of 128 B and is bound by
// its latency (the serial solve of thread 0).
//
// maps_kernel builds a level's inputs to the two: thread p writes pixel p's
// source vertex and its validity and pixel p's target row of vertex and
// normal (the two depths may differ in shape: a SLAM step's first model
// depth is the frame's, not the raycast's). A vertex is
// ((x - cx) * (1 / fx) * d, (y - cy) * (1 / fy) * d, d), 0 where d <= 0,
// each product rounded alone: PyTorch's CUDA division by a Python scalar
// multiplies by its float32 reciprocal. The normal is the forward-difference
// one of geometry/image.py:create_normal_map, from the right and down
// neighbours' vertices (0 past the last column and row), in the order the
// card's eager operations take: the cross product as linalg.cross's kernel
// compiles (a * b - c * d as fmaf(a, b, -(c * d))), the squared norm as the
// reduction over three elements sums it ((x0^2 + x2^2) + x1^2, each square
// rounded, its two threads' partials in that order), sqrtf and an IEEE
// division, and the orientation's dot product summed in that order too. Given
// a normal map, it copies it in place of the computed one. It replaces
// create_vertex_map twice, create_normal_map, the packing torch.cat and
// _LevelData's dead erode_mask: ~660 eager operations a track frame.
// Bound: it reads 8 B a pixel and writes 37 B: at 640x480 2.5 MB in, 11.4 MB
// out, ~4 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerThread = 4;
constexpr int kMaxBlocks = 1024;
constexpr int kTerms = 28;  // 21 of J^T W J, 6 of J^T W r, sum of r^2
constexpr int kRow = 32;    // words a CTA's row of partials takes: the 28 terms, the count
constexpr int kCount = 28;  // the word of the count (an int)

// PyTorch's clamp(min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ double clamp_min(double v, double lo) { return isnan(v) ? v : fmax(v, lo); }

// torch.clamp(torch.round(x).to(int64), 0, n - 1) for any float x.
__device__ __forceinline__ int nearest_index(float x, int n) {
  const float r = rintf(x);
  return r >= static_cast<float>(n - 1) ? n - 1 : (r > 0.0f ? static_cast<int>(r) : 0);
}

// Sum v[0..N) over the CTA: a shuffle tree in each warp, then the warps in
// order. On return thread k < N of the CTA holds the CTA's sum of v[k] in
// out[k] (shared). scratch holds kWarps * N values.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T* scratch, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] = v[k] + __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = scratch[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s = s + scratch[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

struct LevelArgs {
  const float* src;                // (n, 3) source points, camera frame
  const unsigned char* src_valid;  // (n,) bool
  const float* tgt;                // (ht * wt, 6) target vertex + normal rows
  int n, ht, wt;
  float fx, fy, cx, cy;
  float umax, vmax;  // the intrinsic's width - 1 and height - 1
  float trunc, delta;
};

__global__ void __launch_bounds__(kThreads) sums_kernel(LevelArgs a, const float* __restrict__ T,
                                                        float* __restrict__ partials) {
  __shared__ float scratch[kWarps * kTerms];
  __shared__ float tot[kTerms];
  __shared__ int iscratch[kWarps];
  __shared__ int itot[1];
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(T + k);
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  int cnt[1] = {0};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n; i += gridDim.x * kThreads) {
    if (!__ldg(a.src_valid + i)) continue;
    const float p0 = __ldg(a.src + 3 * i), p1 = __ldg(a.src + 3 * i + 1),
                p2 = __ldg(a.src + 3 * i + 2);
    const float P0 = ((m[0] * p0 + m[1] * p1) + m[2] * p2) + m[3];
    const float P1 = ((m[4] * p0 + m[5] * p1) + m[6] * p2) + m[7];
    const float P2 = ((m[8] * p0 + m[9] * p1) + m[10] * p2) + m[11];
    const float zs = clamp_min(P2, 1e-6f);
    const float u = fmaf(P0 / zs, a.fx, a.cx);
    const float v = fmaf(P1 / zs, a.fy, a.cy);
    if (!(P2 > 1e-4f && u >= 0.0f && u <= a.umax && v >= 0.0f && v <= a.vmax)) continue;
    const float* row = a.tgt + 6 * (nearest_index(v, a.ht) * a.wt + nearest_index(u, a.wt));
    const float q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
    const float n0 = __ldg(row + 3), n1 = __ldg(row + 4), n2 = __ldg(row + 5);
    if (!(q2 > 0.0f) || !((n0 * n0 + n1 * n1) + n2 * n2 > 0.5f)) continue;
    const float r = ((P0 - q0) * n0 + (P1 - q1) * n1) + (P2 - q2) * n2;
    if (!(fabsf(r) < a.trunc)) continue;
    const float w = a.delta / clamp_min(fabsf(r), a.delta);
    const float J[6] = {P1 * n2 - P2 * n1, P2 * n0 - P0 * n2, P0 * n1 - P1 * n0, n0, n1, n2};
    float Jw[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) Jw[k] = J[k] * w;
    int t = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int k = j; k < 6; ++k, ++t) acc[t] = acc[t] + Jw[j] * J[k];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[21 + j] = acc[21 + j] + Jw[j] * r;
    if (w > 0.0f) acc[27] = acc[27] + r * r;
    cnt[0] += 1;
  }
  block_sum<float, kTerms>(acc, scratch, tot);
  block_sum<int, 1>(cnt, iscratch, itot);
  float* out = partials + static_cast<size_t>(blockIdx.x) * kRow;
  if (threadIdx.x < kTerms) out[threadIdx.x] = tot[threadIdx.x];
  if (threadIdx.x == kCount) reinterpret_cast<int*>(out)[kCount] = itot[0];
}

// The se(3) exponential of xi = [omega, v] as core/lie.py:se3_exp computes it.
__device__ void se3_exp(const double xi[6], double E[3][4]) {
  const double w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const double th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const double th = sqrt(clamp_min(th2, 1e-16));
  const bool small = th2 < 1e-8;
  const double a = small ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double b = small ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / th2;
  const double c = small ? 1.0 / 6.0 - th2 / 120.0 : (th - sin(th)) / (th2 * th);
  const double W[3][3] = {{0.0, -w2, w1}, {w2, 0.0, -w0}, {-w1, w0, 0.0}};
  double W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W2[i][j] = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
  double V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      E[i][j] = (eye + a * W[i][j]) + b * W2[i][j];
      V[i][j] = (eye + b * W[i][j]) + c * W2[i][j];
    }
  }
  for (int i = 0; i < 3; ++i) E[i][3] = (V[i][0] * xi[3] + V[i][1] * xi[4]) + V[i][2] * xi[5];
}

__global__ void __launch_bounds__(kThreads) solve_kernel(const float* __restrict__ partials,
                                                         int n_blocks, float* T, float* rmse,
                                                         double damping) {
  __shared__ double scratch[kWarps * (kTerms + 1)];
  __shared__ double tot[kTerms + 1];
  double s[kTerms + 1];
#pragma unroll
  for (int k = 0; k <= kTerms; ++k) s[k] = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    const float* row = partials + static_cast<size_t>(b) * kRow;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) s[k] = s[k] + static_cast<double>(row[k]);
    s[kTerms] = s[kTerms] + static_cast<double>(reinterpret_cast<const int*>(row)[kCount]);
  }
  block_sum<double, kTerms + 1>(s, scratch, tot);
  if (threadIdx.x != 0) return;

  // J^T W J from its upper triangle, damped as solve_gn_6x6 damps it
  double A[6][6], rhs[6];
  int t = 0;
  for (int j = 0; j < 6; ++j)
    for (int k = j; k < 6; ++k) A[j][k] = A[k][j] = tot[t++];
  double dmax = A[0][0];
  for (int j = 1; j < 6; ++j) dmax = (isnan(A[j][j]) || A[j][j] > dmax) ? A[j][j] : dmax;
  const double lam = damping * clamp_min(dmax, 1.0);
  for (int j = 0; j < 6; ++j) {
    A[j][j] = A[j][j] + lam;
    rhs[j] = -tot[21 + j];
  }
  // core/linalg.py:cholesky6x6 and solve_cholesky6x6, term for term
  double L[6][6];
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j];
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k];
    d = sqrt(clamp_min(d, 1e-12));
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      double e = A[i][j];
      for (int k = 0; k < j; ++k) e = e - L[i][k] * L[j][k];
      L[i][j] = e / d;
    }
  }
  double y[6], xi[6];
  for (int i = 0; i < 6; ++i) {
    double e = rhs[i];
    for (int k = 0; k < i; ++k) e = e - L[i][k] * y[k];
    y[i] = e / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double e = y[i];
    for (int k = i + 1; k < 6; ++k) e = e - L[k][i] * xi[k];
    xi[i] = e / L[i][i];
  }
  double E[3][4];
  se3_exp(xi, E);
  // T <- exp(xi) T: rows 0-2 from E, row 3 of exp(xi) is (0, 0, 0, 1)
  double Told[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) Told[i][j] = static_cast<double>(T[4 * i + j]);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      T[4 * i + j] = static_cast<float>(
          ((E[i][0] * Told[0][j] + E[i][1] * Told[1][j]) + E[i][2] * Told[2][j]) + E[i][3] * Told[3][j]);
  *rmse = static_cast<float>(sqrt(tot[27] / fmax(tot[kTerms], 1.0)));
}

// A pixel's camera-frame vertex: ((x - cx) * inv_fx * d, (y - cy) * inv_fy * d, d), or 0
// where d <= 0 (or is NaN).
__device__ __forceinline__ void vertex(float d, int x, int y, float inv_fx, float inv_fy, float cx,
                                       float cy, float v[3]) {
  const bool ok = d > 0.0f;
  v[0] = ok ? ((static_cast<float>(x) - cx) * inv_fx) * d : 0.0f;
  v[1] = ok ? ((static_cast<float>(y) - cy) * inv_fy) * d : 0.0f;
  v[2] = ok ? d : 0.0f;
}

__global__ void __launch_bounds__(kThreads) maps_kernel(
    const float* __restrict__ src_depth, const float* __restrict__ tgt_depth,
    const float* __restrict__ tgt_normals, float* __restrict__ src_pts,
    bool* __restrict__ src_valid, float* __restrict__ tgt_rows, int hs, int ws, int H, int W,
    float fx, float fy, float cx, float cy) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  // 1 / fx as PyTorch takes it on the host: float32, correctly rounded
  const float inv_fx = 1.0f / fx, inv_fy = 1.0f / fy;
  if (p < hs * ws) {
    const int ys = p / ws;
    float s[3];
    vertex(__ldg(src_depth + p), p - ys * ws, ys, inv_fx, inv_fy, cx, cy, s);
    src_pts[3 * p] = s[0];
    src_pts[3 * p + 1] = s[1];
    src_pts[3 * p + 2] = s[2];
    src_valid[p] = s[2] > 0.0f;
  }
  if (p >= H * W) return;
  const int y = p / W, x = p - y * W;
  float t[3];
  vertex(__ldg(tgt_depth + p), x, y, inv_fx, inv_fy, cx, cy, t);
  float* row = tgt_rows + 6 * static_cast<size_t>(p);
  row[0] = t[0];
  row[1] = t[1];
  row[2] = t[2];
  if (tgt_normals != nullptr) {
    row[3] = __ldg(tgt_normals + 3 * p);
    row[4] = __ldg(tgt_normals + 3 * p + 1);
    row[5] = __ldg(tgt_normals + 3 * p + 2);
    return;
  }
  float r[3] = {0.0f, 0.0f, 0.0f}, dn[3] = {0.0f, 0.0f, 0.0f};
  if (x + 1 < W) vertex(__ldg(tgt_depth + p + 1), x + 1, y, inv_fx, inv_fy, cx, cy, r);
  if (y + 1 < H) vertex(__ldg(tgt_depth + p + W), x, y + 1, inv_fx, inv_fy, cx, cy, dn);
  float n[3] = {0.0f, 0.0f, 0.0f};
  if (t[2] > 0.0f && r[2] > 0.0f && dn[2] > 0.0f) {
    const float a[3] = {r[0] - t[0], r[1] - t[1], r[2] - t[2]};
    const float b[3] = {dn[0] - t[0], dn[1] - t[1], dn[2] - t[2]};
    const float c[3] = {fmaf(a[1], b[2], -(a[2] * b[1])), fmaf(a[2], b[0], -(a[0] * b[2])),
                        fmaf(a[0], b[1], -(a[1] * b[0]))};
    const float sq = (c[0] * c[0] + c[2] * c[2]) + c[1] * c[1];
    const float norm = clamp_min(sqrtf(sq), 1e-12f);
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = c[k] / norm;
    if ((n[0] * t[0] + n[2] * t[2]) + n[1] * t[1] > 0.0f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) n[k] = -n[k];
    }
  }
  row[3] = n[0];
  row[4] = n[1];
  row[5] = n[2];
}

}  // namespace

// The number of CTAs (rows of partials) sums_kernel takes for n source pixels.
extern "C" int o3dt_p2p_blocks(int n) {
  const int per = kThreads * kPixelsPerThread;
  const int b = (n + per - 1) / per;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// partials (o3dt_p2p_blocks(n), 32) = the point-to-plane sums of the source
// points at pose T (4, 4) against the target rows.
extern "C" int o3dt_p2p_sums(const void* src, const void* src_valid, const void* tgt, const void* T,
                             void* partials, int n, int ht, int wt, float fx, float fy, float cx,
                             float cy, float umax, float vmax, float trunc, float delta,
                             void* stream) {
  LevelArgs a{static_cast<const float*>(src), static_cast<const unsigned char*>(src_valid),
              static_cast<const float*>(tgt), n, ht, wt, fx, fy, cx, cy, umax, vmax, trunc, delta};
  sums_kernel<<<o3dt_p2p_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(T), static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// T (4, 4) <- exp(xi) T, with xi the damped Gauss-Newton step of the sums in
// partials (n_blocks, 32); rmse (1,) = their RMSE.
extern "C" int o3dt_p2p_solve(const void* partials, int n_blocks, void* T, void* rmse,
                              double damping, void* stream) {
  solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n_blocks, static_cast<float*>(T),
      static_cast<float*>(rmse), damping);
  return static_cast<int>(cudaGetLastError());
}

// A level's maps: src_pts (hs * ws, 3) and src_valid (hs * ws,) bool from the
// (hs, ws) source depth, tgt_rows (ht, wt, 6) the (ht, wt) target's vertex and
// normal, the normal copied from tgt_normals (ht, wt, 3) where that is not null.
extern "C" int o3dt_p2p_maps(const void* src_depth, const void* tgt_depth, const void* tgt_normals,
                             void* src_pts, void* src_valid, void* tgt_rows, int hs, int ws, int ht,
                             int wt, float fx, float fy, float cx, float cy, void* stream) {
  const int n = hs * ws > ht * wt ? hs * ws : ht * wt;
  maps_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src_depth), static_cast<const float*>(tgt_depth),
      static_cast<const float*>(tgt_normals), static_cast<float*>(src_pts),
      static_cast<bool*>(src_valid), static_cast<float*>(tgt_rows), hs, ws, ht, wt, fx, fy, cx, cy);
  return static_cast<int>(cudaGetLastError());
}
