// Primitive probes: out = sum_{i < iters} body(i, inputs), accumulated in
// out's type from zeros with i in order, for the 17 bodies of
// scripts/perf_micro.py:main. The time of one instance of a body is the
// slope of the launch time over iters.
//
// Replaces scripts/perf_micro.py:_run_one (the pallas_call at :39) and
// computes each body's function, one kernel template per family:
//   elementwise_kernel  x * (1 + i) (mul), x + i kept in flat order
//                       (reshape), transposed (transpose), broadcast along
//                       a new last axis and times 1 (bcast);
//   gather_kernel       take_along_axis(x + i, idx, axis 1), all 128 lanes
//                       or one (torch.gather semantics);
//   maskmul_kernel      sum over lanes of (x + i) * (lane == idx);
//   segment_kernel      five sums of 128 lanes of x + i;
//   sublane_kernel      sums of x + i over 128 rows of each (128, 128) slab;
//   onehot_kernel       (lane == idx + i) as bfloat16, accumulated in
//                       bfloat16;
//   mma_bf16_kernel     (a + bf16(i)) @ b, bfloat16 in, float32 sums, on the
//                       tensor cores with mma.sync m16n8k16 written here;
//   ffma_kernel         (a + i) @ v in float32 with fmaf, not TF32, as the
//                       interpreted kernel computes it.
//
// Bound: operations. The instance's `+ i`, its accumulate and the operation
// itself, over the float32 rate (the bfloat16 tensor rate for mma_bf16).
// The inputs are staged into shared memory once a launch and stay there for
// every iteration, so device memory is not what the slope measures.
//
// Design: every CTA stages its slice of the inputs into shared memory and
// keeps its outputs' sums in registers across the iterations. Where a
// thread's inputs would fit in its registers (the elementwise, relayout,
// gather, reduction and one-hot probes) it reads them through a volatile
// pointer in every iteration, as the script's body reads its VMEM refs in
// every iteration: the loop then times the shared-memory access pattern of
// the relayout or gather, and no load is hoisted. The index enters the
// arithmetic as the body has it (float(i) for float32, bf16(i) for the
// bfloat16 product, i for the one-hot compare) and each iteration's value is
// added to the sum, so the accumulate cannot be hoisted either. The products
// keep their operands in shared memory and read them with ordinary loads
// (A and V as float4 rows for fmaf, 32-bit fragments for mma.sync), which
// the compiler may keep in registers; the `+ i`, the product and the
// accumulate still run every iteration. Rows are laid out or padded so that
// no load conflicts on a bank, except where a probe's own access pattern
// does (the gathers).
//
// Launch geometry: every probe but the five smallest launches at least 128
// CTAs, so that 128 or more of the 132 multiprocessors hold warps (with
// 16-80 CTAs a probe times idle multiprocessors, not its primitive): the
// products take 2 x 2 (fmaf) or 32 x 32 (mma.sync) outputs a warp in small
// CTAs, the sublane sum a warp of 8 columns. The five smallest, with 2048 to
// 4096 outputs (mul (2048,1), mul (32,128), reshape, the one-column gather,
// transpose (2048,8)), are bound by the latency of their loop-carried
// accumulate, one dependent add an iteration, which more CTAs do not shorten.
//
// Rounding: --fmad=false and no fmaf outside the float32 products, so the
// elementwise, relayout, gather, reduction and one-hot probes agree bit for
// bit with the plain PyTorch version (whose row sums take this file's order:
// lane partials, then the warp's xor butterfly); the products sum in
// another order than cuBLAS and agree within the bars chip_smoke.py states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // the TPU lane width every probe's rows have

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// ---- elementwise and relayout --------------------------------------------
// KIND 0 mul: out[o] = sum_i x[o] * (1 + i)
// KIND 1 reshape: out[o] = sum_i x[o] + i
// KIND 3 bcast: out[o] = sum_i (x[o / inner] + i) * 1
template <int KIND>
__global__ void __launch_bounds__(kThreads) flat_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int n_out,
                                                        int inner, int iters) {
  __shared__ float xs[kThreads + 1];
  const int o0 = blockIdx.x * kThreads;
  const int o = o0 + threadIdx.x;
  const int s0 = o0 / inner;
  const int last = min(o0 + kThreads, n_out) - 1;
  const int ns = last / inner - s0 + 1;
  for (int j = threadIdx.x; j < ns; j += kThreads) xs[j] = x[s0 + j];
  __syncthreads();
  if (o >= n_out) return;
  const volatile float* xv = xs + (o / inner - s0);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
    if (KIND == 0) {
      acc = acc + *xv * (1.0f + fi);
    } else if (KIND == 1) {
      acc = acc + (*xv + fi);
    } else {
      acc = acc + (*xv + fi) * 1.0f;
    }
  }
  out[o] = acc;
}

// transpose: x (rows, cols) -> out (cols, rows), out[c][r] = sum_i x[r][c] + i.
// A CTA takes a 32 x tc tile of x (tc = min(32, cols)) in its own layout,
// padded to 33 columns, and each iteration reads it down the columns.
__global__ void __launch_bounds__(kThreads) transpose_kernel(const float* __restrict__ x,
                                                             float* __restrict__ out, int rows,
                                                             int cols, int iters) {
  __shared__ float xs[32][33];
  const int tc = min(32, cols);
  const int c0 = blockIdx.x * tc;
  const int r0 = blockIdx.y * 32;
  for (int j = threadIdx.x; j < 32 * tc; j += kThreads) {
    xs[j / tc][j % tc] = x[static_cast<int64_t>(r0 + j / tc) * cols + c0 + j % tc];
  }
  __syncthreads();
  const int n = (32 * tc) / kThreads > 0 ? (32 * tc) / kThreads : 1;  // 4 or 1 a thread
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const volatile float* src[4];
  for (int q = 0; q < 4; ++q) {
    const int j = threadIdx.x + kThreads * q;
    src[q] = &xs[j % 32][(j / 32) % 32];
  }
  if (threadIdx.x >= 32 * tc) return;
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < n) acc[q] = acc[q] + (*src[q] + fi);
    }
  }
  for (int q = 0; q < n; ++q) {
    const int j = threadIdx.x + kThreads * q;
    out[static_cast<int64_t>(c0 + j / 32) * rows + r0 + j % 32] = acc[q];
  }
}

// ---- row gather ------------------------------------------------------------
// out[r][c] = sum_i x[r][idx[r][c]] + i over W = 128 columns (a warp a row,
// 8 rows a CTA), or W = 1 column (a thread a row, 64 rows a CTA).
template <int W>
__global__ void __launch_bounds__(W == kLanes ? kThreads : 64)
    gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                  float* __restrict__ out, int rows, int iters) {
  constexpr int kRowsCta = W == kLanes ? 8 : 64;
  constexpr int kNt = W == kLanes ? kThreads : 64;
  __shared__ float xs[kRowsCta * kLanes];
  __shared__ int32_t is[kRowsCta * W];
  const int r0 = blockIdx.x * kRowsCta;
  const int nr = min(kRowsCta, rows - r0);
  for (int j = threadIdx.x; j < nr * kLanes; j += kNt) xs[j] = x[static_cast<int64_t>(r0) * kLanes + j];
  for (int j = threadIdx.x; j < nr * W; j += kNt) {
    const int32_t v = idx[static_cast<int64_t>(r0) * W + j];
    if (static_cast<unsigned>(v) >= static_cast<unsigned>(kLanes)) __trap();  // never read past a row
    is[j] = v;
  }
  __syncthreads();
  const volatile float* xv = xs;
  const volatile int32_t* iv = is;
  if (W == kLanes) {
    const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (row >= nr) return;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < iters; ++i) {
      const float fi = static_cast<float>(i);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = iv[row * kLanes + lane + 32 * q];
        acc[q] = acc[q] + (xv[row * kLanes + j] + fi);
      }
    }
    for (int q = 0; q < 4; ++q) out[static_cast<int64_t>(r0 + row) * kLanes + lane + 32 * q] = acc[q];
  } else {
    const int row = threadIdx.x;
    if (row >= nr) return;
    float acc = 0.0f;
    for (int i = 0; i < iters; ++i) {
      const int j = iv[row];
      acc = acc + (xv[row * kLanes + j] + static_cast<float>(i));
    }
    out[r0 + row] = acc;
  }
}

// ---- row reductions --------------------------------------------------------
// out[r] = sum_i sum_l (x[r][l] + i) * (l == idx[r]): a warp a row, 8 rows a CTA.
__global__ void __launch_bounds__(kThreads) maskmul_kernel(const float* __restrict__ x,
                                                           const int32_t* __restrict__ idx,
                                                           float* __restrict__ out, int rows,
                                                           int iters) {
  __shared__ float xs[8 * kLanes];
  __shared__ int32_t is[8];
  const int r0 = blockIdx.x * 8;
  const int nr = min(8, rows - r0);
  for (int j = threadIdx.x; j < nr * kLanes; j += kThreads) xs[j] = x[static_cast<int64_t>(r0) * kLanes + j];
  if (threadIdx.x < nr) is[threadIdx.x] = idx[r0 + threadIdx.x];
  __syncthreads();
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (row >= nr) return;
  const volatile float* xv = xs + row * kLanes;
  const volatile int32_t* iv = is + row;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
    const int id = *iv;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = lane + 32 * q;
      s = s + (xv[l] + fi) * (l == id ? 1.0f : 0.0f);
    }
    acc = acc + warp_sum(s);
  }
  if (lane == 0) out[r0 + row] = acc;
}

// out[r][p] = sum_i sum_{l < 128} x[r][128 p + l] + i for p < 5: a warp a
// row, 8 rows a CTA.
__global__ void __launch_bounds__(kThreads) segment_kernel(const float* __restrict__ x,
                                                           float* __restrict__ out, int rows,
                                                           int iters) {
  constexpr int kSeg = 5, kCols = kSeg * kLanes;
  __shared__ float xs[8 * kCols];
  const int r0 = blockIdx.x * 8;
  const int nr = min(8, rows - r0);
  for (int j = threadIdx.x; j < nr * kCols; j += kThreads) xs[j] = x[static_cast<int64_t>(r0) * kCols + j];
  __syncthreads();
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (row >= nr) return;
  const volatile float* xv = xs + row * kCols;
  float acc[kSeg] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int p = 0; p < kSeg; ++p) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) s = s + (xv[p * kLanes + lane + 32 * q] + fi);
      acc[p] = acc[p] + warp_sum(s);
    }
  }
  if (lane < kSeg) {
    float v = acc[0];
#pragma unroll
    for (int p = 1; p < kSeg; ++p) v = lane == p ? acc[p] : v;
    out[static_cast<int64_t>(r0 + row) * kSeg + lane] = v;
  }
}

// out[a][c] = sum_i sum_{b < 128} x[128 a + b][c] + i. The sum over b keeps
// the order the plain version mirrors: four running sums s_j over the rows
// b = 4 t + j, t in order, then (s0 + s1) + (s2 + s3). Those 8192 chains (16
// slabs x 128 columns x 4) are the probe's parallelism, so each is a thread:
// a warp takes 8 columns of one slab, lane 4 c + j the chain s_j of column c,
// and two xor shuffles add the four in that order. A warp is a CTA, so the 256
// warps spread over every multiprocessor. The warp's 128 x 8 slice is staged
// column-minor, where the 32 lanes read 32 distinct banks.
constexpr int kSubCols = 8;

__global__ void __launch_bounds__(32) sublane_kernel(const float* __restrict__ x,
                                                     float* __restrict__ out, int iters) {
  __shared__ float xs[kLanes * kSubCols];  // [b][c]
  const int a = blockIdx.y, c0 = blockIdx.x * kSubCols;
  const int lane = threadIdx.x, c = lane >> 2, j = lane & 3;
  const float* src = x + static_cast<int64_t>(a) * kLanes * kLanes + c0;
  for (int e = lane; e < kLanes * kSubCols; e += 32) xs[e] = src[(e / kSubCols) * kLanes + e % kSubCols];
  __syncwarp();
  const volatile float* xv = xs + j * kSubCols + c;  // row b = 4 t + j at xv[4 t * kSubCols]
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < kLanes / 4; ++t) s = s + (xv[4 * t * kSubCols] + fi);
    s = s + __shfl_xor_sync(0xffffffffu, s, 1);  // s0 + s1, s2 + s3
    s = s + __shfl_xor_sync(0xffffffffu, s, 2);  // (s0 + s1) + (s2 + s3)
    acc = acc + s;
  }
  if (j == 0) out[a * kLanes + c0 + c] = acc;
}

// ---- one-hot build ---------------------------------------------------------
// out[r][c] = sum_i bf16(c == idx[r] + i), summed in bfloat16: two columns a
// thread, 4 rows a CTA.
__global__ void __launch_bounds__(kThreads) onehot_kernel(const int32_t* __restrict__ idx,
                                                          __nv_bfloat162* __restrict__ out,
                                                          int rows, int iters) {
  __shared__ int32_t is[4];
  const int r0 = blockIdx.x * 4;
  if (threadIdx.x < 4 && r0 + threadIdx.x < rows) is[threadIdx.x] = idx[r0 + threadIdx.x];
  __syncthreads();
  const int row = threadIdx.x >> 6, c = (threadIdx.x & 63) * 2;
  if (r0 + row >= rows) return;
  const volatile int32_t* iv = is + row;
  __nv_bfloat162 acc = __floats2bfloat162_rn(0.0f, 0.0f);
  for (int i = 0; i < iters; ++i) {
    const int id = *iv + i;
    acc = __hadd2(acc, __floats2bfloat162_rn(c == id ? 1.0f : 0.0f, c + 1 == id ? 1.0f : 0.0f));
  }
  out[(static_cast<int64_t>(r0 + row) * kLanes + c) / 2] = acc;
}

// ---- bfloat16 product on the tensor cores ------------------------------------
// out (M, N) = sum_i (a + bf16(i)) @ b, a (M, K), b (K, N) bfloat16, float32
// sums. A CTA takes a 64 x 32 tile of out and all of K; 2 warps as 2 x 1,
// each warp 32 x 32 of out as 2 x 4 mma.sync m16n8k16 tiles. The small tile
// gives 128 CTAs for N = 128 and 640 for N = 640. a is staged row by row and b transposed (n by k), both padded
// by 8 bfloat16 a row, so the 32-bit fragment loads hit 32 distinct banks.
constexpr int kMmaRows = 64, kMmaCols = 32;
constexpr int kMmaWarpsM = kMmaRows / 32, kMmaThreads = 32 * kMmaWarpsM * (kMmaCols / 32);

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t v, __nv_bfloat162 s) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hadd2(h, s);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kMmaThreads) mma_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                                                            const __nv_bfloat16* __restrict__ b,
                                                            float* __restrict__ out, int K, int N,
                                                            int iters) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int ld = K + 8;
  __nv_bfloat16* as = sm;                  // [kMmaRows][ld]
  __nv_bfloat16* bs = sm + kMmaRows * ld;  // [kMmaCols][ld], b transposed
  const int m0 = blockIdx.y * kMmaRows, n0 = blockIdx.x * kMmaCols;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  uint32_t* as32 = reinterpret_cast<uint32_t*>(as);
  for (int j = threadIdx.x; j < kMmaRows * K / 2; j += kMmaThreads) {
    const int m = j / (K / 2), kk = j % (K / 2);
    as32[m * (ld / 2) + kk] = a32[static_cast<int64_t>(m0 + m) * (K / 2) + kk];
  }
  for (int j = threadIdx.x; j < kMmaCols * K; j += kMmaThreads) {
    const int n = j % kMmaCols, k = j / kMmaCols;
    bs[n * ld + k] = b[static_cast<int64_t>(k) * N + n0 + n];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % kMmaWarpsM, wn = warp / kMmaWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int i = 0; i < iters; ++i) {
    const __nv_bfloat162 ib = __bfloat162bfloat162(__float2bfloat16_rn(static_cast<float>(i)));
    float p[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.0f;
    for (int ks = 0; ks < K / 16; ++ks) {
      const int col = ks * 16 + t4 * 2;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + g;
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(as + row * ld + col);
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(as + (row + 8) * ld + col);
        af[mt][0] = add_bf16x2(lo[0], ib);
        af[mt][1] = add_bf16x2(hi[0], ib);
        af[mt][2] = add_bf16x2(lo[4], ib);
        af[mt][3] = add_bf16x2(hi[4], ib);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* bp =
            reinterpret_cast<const uint32_t*>(bs + (wn * 32 + nt * 8 + g) * ld + col);
        bf[nt][0] = bp[0];
        bf[nt][1] = bp[4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(p[mt][nt], af[mt], bf[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = acc[mt][nt][e] + p[mt][nt][e];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm * 32 + mt * 16 + g;
      const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
      out[static_cast<int64_t>(row) * N + col] = acc[mt][nt][0];
      out[static_cast<int64_t>(row) * N + col + 1] = acc[mt][nt][1];
      out[static_cast<int64_t>(row + 8) * N + col] = acc[mt][nt][2];
      out[static_cast<int64_t>(row + 8) * N + col + 1] = acc[mt][nt][3];
    }
  }
}

// ---- float32 product with fmaf -------------------------------------------------
// out (16, N) = sum_i (a + i) @ v, a (16, K), v (K, N) float32. A warp takes
// 2 rows x 2 columns of out: lane l reads the float4s k4 = l + 32 q of its
// two rows of a and two columns of v, adds i to the a values once for both
// columns, and keeps four fmaf chains (one a float4 component) for each of
// its 4 outputs; an output's chains are added as (s0 + s1) + (s2 + s3) and
// the warp's xor butterfly sums the lanes. The 2 x 2 tile reads 4 bytes of
// shared memory an fmaf, where an output a warp would read 8. A CTA is 4
// warps as 2 x 2, so 4 rows x 4 columns: N = 128 gives 128 CTAs and N = 640
// gives 640. The CTA's rows of a and
// columns of v (transposed) are staged unpadded; a warp's float4 loads are
// consecutive. cuBLAS sums in another order, within tolerance().
constexpr int kFfmaRows = 4, kFfmaCols = 4, kFfmaThreads = 32 * (kFfmaRows / 2) * (kFfmaCols / 2);

__global__ void __launch_bounds__(kFfmaThreads) ffma_kernel(const float* __restrict__ a,
                                                            const float* __restrict__ v,
                                                            float* __restrict__ out, int K, int N,
                                                            int iters) {
  extern __shared__ __align__(16) float fs[];
  float* as = fs;                  // [kFfmaRows][K]
  float* vs = fs + kFfmaRows * K;  // [kFfmaCols][K], v transposed
  const int r0 = blockIdx.y * kFfmaRows, n0 = blockIdx.x * kFfmaCols;
  for (int j = threadIdx.x; j < kFfmaRows * K; j += kFfmaThreads) as[j] = a[static_cast<int64_t>(r0) * K + j];
  for (int j = threadIdx.x; j < kFfmaCols * K; j += kFfmaThreads) {
    const int c = j % kFfmaCols, k = j / kFfmaCols;
    vs[c * K + k] = v[static_cast<int64_t>(k) * N + n0 + c];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = 2 * (warp / (kFfmaCols / 2)), c = 2 * (warp % (kFfmaCols / 2));
  const float4* a0 = reinterpret_cast<const float4*>(as + r * K) + lane;
  const float4* a1 = reinterpret_cast<const float4*>(as + (r + 1) * K) + lane;
  const float4* v0 = reinterpret_cast<const float4*>(vs + c * K) + lane;
  const float4* v1 = reinterpret_cast<const float4*>(vs + (c + 1) * K) + lane;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
    float s[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] = 0.0f;
#pragma unroll 2
    for (int q = 0; q < K / 128; ++q) {
      const float4 x[2] = {a0[32 * q], a1[32 * q]}, y[2] = {v0[32 * q], v1[32 * q]};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float p0 = x[m].x + fi, p1 = x[m].y + fi, p2 = x[m].z + fi, p3 = x[m].w + fi;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          s[m][n][0] = fmaf(p0, y[n].x, s[m][n][0]);
          s[m][n][1] = fmaf(p1, y[n].y, s[m][n][1]);
          s[m][n][2] = fmaf(p2, y[n].z, s[m][n][2]);
          s[m][n][3] = fmaf(p3, y[n].w, s[m][n][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[m][n] = acc[m][n] + warp_sum((s[m][n][0] + s[m][n][1]) + (s[m][n][2] + s[m][n][3]));
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) out[static_cast<int64_t>(r0 + r + m) * N + n0 + c + n] = acc[m][n];
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// kind: 0 mul, 1 reshape, 2 transpose, 3 bcast; x is (rows, cols).
extern "C" int o3dt_probe_elementwise(const void* x, void* out, int kind, int rows, int cols,
                                      int n_out, int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const int grid = (n_out + kThreads - 1) / kThreads;
  if (kind == 0) {
    flat_kernel<0><<<grid, kThreads, 0, s>>>(xf, of, n_out, 1, iters);
  } else if (kind == 1) {
    flat_kernel<1><<<grid, kThreads, 0, s>>>(xf, of, n_out, 1, iters);
  } else if (kind == 2) {
    const int tc = cols < 32 ? cols : 32;
    if (rows % 32 != 0 || cols % tc != 0 || n_out != rows * cols) return cudaErrorInvalidValue;
    transpose_kernel<<<dim3(cols / tc, rows / 32), kThreads, 0, s>>>(xf, of, rows, cols, iters);
  } else if (kind == 3) {
    const int inner = n_out / (rows * cols);
    if (inner <= 0 || n_out != inner * rows * cols) return cudaErrorInvalidValue;
    flat_kernel<3><<<grid, kThreads, 0, s>>>(xf, of, n_out, inner, iters);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// x (rows, 128) float32, idx (rows, width) int32 with width 128 or 1.
extern "C" int o3dt_probe_gather(const void* x, const void* idx, void* out, int rows, int width,
                                 int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  float* of = static_cast<float*>(out);
  if (width == kLanes) {
    gather_kernel<kLanes><<<(rows + 7) / 8, kThreads, 0, s>>>(xf, ii, of, rows, iters);
  } else if (width == 1) {
    gather_kernel<1><<<(rows + 63) / 64, 64, 0, s>>>(xf, ii, of, rows, iters);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 maskmul (x (rows, 128), idx (rows, 1)), 1 segment (x (rows, 640)),
// 2 sublane (x (rows, 128), rows a multiple of 128).
extern "C" int o3dt_probe_reduce(const void* x, const void* idx, void* out, int kind, int rows,
                                 int cols, int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (kind == 0 && cols == kLanes) {
    maskmul_kernel<<<(rows + 7) / 8, kThreads, 0, s>>>(xf, static_cast<const int32_t*>(idx), of,
                                                       rows, iters);
  } else if (kind == 1 && cols == 5 * kLanes) {
    segment_kernel<<<(rows + 7) / 8, kThreads, 0, s>>>(xf, of, rows, iters);
  } else if (kind == 2 && cols == kLanes && rows % kLanes == 0) {
    sublane_kernel<<<dim3(kLanes / kSubCols, rows / kLanes), 32, 0, s>>>(xf, of, iters);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// idx (rows, 1) int32 -> out (rows, 128) bfloat16.
extern "C" int o3dt_probe_onehot(const void* idx, void* out, int rows, int cols, int iters,
                                 void* stream) {
  if (cols != kLanes) return cudaErrorInvalidValue;
  onehot_kernel<<<(rows + 3) / 4, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<__nv_bfloat162*>(out), rows, iters);
  return static_cast<int>(cudaGetLastError());
}

// a (M, K), b (K, N) bfloat16 -> out (M, N) float32; M % 64, N % 32, K % 16 == 0.
extern "C" int o3dt_probe_mma_bf16(const void* a, const void* b, void* out, int M, int K, int N,
                                   int iters, void* stream) {
  if (M % kMmaRows != 0 || N % kMmaCols != 0 || K % 16 != 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kMmaRows + kMmaCols) * (K + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(mma_bf16_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_bf16_kernel<<<dim3(N / kMmaCols, M / kMmaRows), kMmaThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), K, N, iters);
  return static_cast<int>(cudaGetLastError());
}

// a (M, K), v (K, N) float32 -> out (M, N) float32; M % 4, N % 4, K % 128 == 0.
extern "C" int o3dt_probe_ffma(const void* a, const void* v, void* out, int M, int K, int N,
                               int iters, void* stream) {
  if (M % kFfmaRows != 0 || N % kFfmaCols != 0 || K % 128 != 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kFfmaRows + kFfmaCols) * K * sizeof(float);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(ffma_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffma_kernel<<<dim3(N / kFfmaCols, M / kFfmaRows), kFfmaThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(v), static_cast<float*>(out), K, N,
      iters);
  return static_cast<int>(cudaGetLastError());
}
