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
//   wgmma_bf16_kernel   (a + bf16(i)) @ b, bfloat16 in, float32 sums, on the
//                       tensor cores with wgmma.mma_async written here;
//   ffma_kernel         (a + i) @ v in float32 with fmaf, not TF32, as the
//                       interpreted kernel computes it.
//
// Bound: operations. The instance's `+ i`, its accumulate and the operation
// itself, over the float32 rate (the bfloat16 tensor rate for the bfloat16
// product). The inputs are read from device memory once a launch and stay in
// shared memory or registers for every iteration, so device memory is not
// what the slope measures.
//
// Design: every thread keeps its outputs' sums in registers across the
// iterations. Where a probe times a shared-memory access pattern (the
// elementwise, relayout, gather, mask-multiply and one-hot probes), its CTA
// stages its slice of the inputs into shared memory once and reads it
// through a volatile pointer in every iteration, as the script's body reads
// its VMEM refs in every iteration, so no load is hoisted. The segment sum,
// the sublane sum and the two products keep their inputs in registers (the
// bfloat16 product's b in shared memory, where wgmma reads it) and keep
// per-thread partials across the iterations, reduced across lanes, warps
// and CTAs once after the loop: sum_i sum_k is sum_k sum_i. The index enters
// the arithmetic as the body has it (float(i) for float32, bf16(i) for the
// bfloat16 product, i for the one-hot compare), and every `+ i`, product
// and accumulate of an instance runs in its own iteration.
//
// Launch geometry: every probe but the five smallest launches at least 128
// CTAs, so that 128 or more of the 132 multiprocessors hold warps. The five
// smallest, with 2048 to 4096 outputs (mul (2048,1), mul (32,128), reshape,
// the one-column gather, transpose (2048,8)), are bound by the latency of
// their loop-carried accumulate, one dependent add an iteration, which more
// CTAs do not shorten.
//
// Rounding: --fmad=false and no fmaf outside the float32 product, so the
// elementwise, relayout, gather, reduction and one-hot probes agree bit for
// bit with the plain PyTorch version (whose row sums take this file's
// order); the products sum in another order than cuBLAS and agree within the
// bars micro_primitives.tolerance states.
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
// row, 8 rows a CTA. Lane l keeps its 20 values x[r][128 p + l + 32 q] in
// registers and, for each segment, a partial over the iterations of its four
// values' sum ((v0 + v1) + v2) + v3; the warp's xor butterfly adds the 32
// lane partials once, after the loop (sum over i, then over lanes).
__global__ void __launch_bounds__(kThreads) segment_kernel(const float* __restrict__ x,
                                                           float* __restrict__ out, int rows,
                                                           int iters) {
  constexpr int kSeg = 5, kCols = kSeg * kLanes;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* src = x + static_cast<int64_t>(row) * kCols + lane;
  float xv[kSeg][4];
#pragma unroll
  for (int p = 0; p < kSeg; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) xv[p][q] = src[p * kLanes + 32 * q];
  float acc[kSeg] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int p = 0; p < kSeg; ++p) {
      const float s = (((xv[p][0] + fi) + (xv[p][1] + fi)) + (xv[p][2] + fi)) + (xv[p][3] + fi);
      acc[p] = acc[p] + s;
    }
  }
#pragma unroll
  for (int p = 0; p < kSeg; ++p) acc[p] = warp_sum(acc[p]);
  if (lane < kSeg) {
    float v = acc[0];
#pragma unroll
    for (int p = 1; p < kSeg; ++p) v = lane == p ? acc[p] : v;
    out[static_cast<int64_t>(row) * kSeg + lane] = v;
  }
}

// out[a][c] = sum_i sum_{b < 128} x[128 a + b][c] + i. A thread keeps 16 rows
// b = 16 g + j of one column in registers and 16 independent partials over
// the iterations, p_j = sum_i x[128 a + 16 g + j][c] + i, so an iteration is
// 32 adds with no chain longer than one add. After the loop the thread sums
// its partials in j order and three xor shuffles add the 8 row groups g
// (lanes 8 cc + g: a warp takes 4 columns); the plain version takes that
// order. 16 slabs x 128 columns x 8 groups = 512 warps in 128 CTAs of 4.
constexpr int kSubRows = 16, kSubGroups = kLanes / kSubRows, kSubColsWarp = 32 / kSubGroups;
constexpr int kSubThreads = 128, kSubColsCta = kSubColsWarp * (kSubThreads / 32);

__global__ void __launch_bounds__(kSubThreads) sublane_kernel(const float* __restrict__ x,
                                                              float* __restrict__ out, int iters) {
  const int a = blockIdx.y, lane = threadIdx.x & 31, g = lane % kSubGroups;
  const int c = blockIdx.x * kSubColsCta + (threadIdx.x >> 5) * kSubColsWarp + lane / kSubGroups;
  const float* src = x + (static_cast<int64_t>(a) * kLanes + kSubRows * g) * kLanes + c;
  float xv[kSubRows], p[kSubRows];
#pragma unroll
  for (int j = 0; j < kSubRows; ++j) {
    xv[j] = src[j * kLanes];
    p[j] = 0.0f;
  }
  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int j = 0; j < kSubRows; ++j) p[j] = p[j] + (xv[j] + fi);
  }
  float t = p[0];
#pragma unroll
  for (int j = 1; j < kSubRows; ++j) t = t + p[j];
#pragma unroll
  for (int off = kSubGroups / 2; off > 0; off >>= 1) t = t + __shfl_xor_sync(0xffffffffu, t, off);
  if (g == 0) out[a * kLanes + c] = t;
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

// ---- bfloat16 product on the tensor cores (wgmma) -----------------------------
// out (M, N) = sum_i (a + bf16(i)) @ b, a (M, 128), b (128, N) bfloat16,
// float32 sums. One warpgroup (128 threads) a CTA takes a 64 x NT tile of out
// with wgmma.mma_async m64nNTk16, NT = 80 where N is a multiple of 80 (256
// CTAs for N = 640, two a multiprocessor), else 32 (128 CTAs for N = 128).
//   A from registers: a thread loads its m64k16 fragments of a once (8
//     k-steps x 4 registers, the mma.sync m16n8k16 layout, warp w rows
//     16 w ... 16 w + 15) and adds bf16(i) to them each iteration with one
//     bfloat16 add (round to nearest), as the body's a + i.astype(bf16).
//   B from shared memory: b^T (NT x 128) is staged once a launch in the
//     no-swizzle K-major core-matrix layout (8 rows x 16 bytes, 128 bytes
//     contiguous; the two k-halves of a k-step 128 bytes apart, 8-row groups
//     2048 bytes apart), so every core matrix is one conflict-free 128-byte
//     read; a k-step's descriptor starts 256 bytes after the last.
//   Each iteration's product starts at scale-d = 0 on its first k-step and
//   is added to a separate float32 sum with a round-to-nearest add: the
//   tensor cores truncate into their accumulator, and 1000-9000 truncations
//   into a sum near 1.6e7 would approach the 1e-4 bar. Two product buffers
//   and two A buffers alternate, so iteration i + 1's products are issued
//   before iteration i's are added (wait_group 1).
constexpr int kMmaRows = 64, kMmaK = 128, kMmaKSteps = kMmaK / 16, kMmaThreads = 128;
constexpr int kMmaWide = 80, kMmaNarrow = 32;

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t v, __nv_bfloat162 s) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hadd2(h, s);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n80k16(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  if constexpr (NT == kMmaWide) {
    wgmma_m64n80k16(d, a, desc, scale_d);
  } else {
    wgmma_m64n32k16(d, a, desc, scale_d);
  }
}

// Keeps the compiler from moving reads or writes of v across this point
// (the wgmma results are written behind its back until wait_group).
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

template <int N_WAIT>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N_WAIT) : "memory");
}

// A shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (the next core matrix along k), stride byte offset (the next
// 8-row group), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The products of one iteration: A fragments af (already + bf16(i)) times
// the staged b, into d, as one committed wgmma group.
template <int NT>
__device__ __forceinline__ void issue_products(float* d, const uint32_t (&af)[kMmaKSteps][4],
                                               uint64_t desc) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) fence_operand(d[j]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kMmaKSteps; ++ks) wgmma_tile<NT>(d, af[ks], desc + ks * (256 >> 4), ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void add_index(uint32_t (&am)[kMmaKSteps][4],
                                          const uint32_t (&af)[kMmaKSteps][4], int i) {
  const __nv_bfloat162 ib = __bfloat162bfloat162(__float2bfloat16_rn(static_cast<float>(i)));
#pragma unroll
  for (int ks = 0; ks < kMmaKSteps; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) am[ks][r] = add_bf16x2(af[ks][r], ib);
}

// acc += d, after d's group has completed.
template <int NT>
__device__ __forceinline__ void add_products(float* acc, float* d) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    fence_operand(d[j]);
    acc[j] = acc[j] + d[j];
  }
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads) wgmma_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                                                                const __nv_bfloat16* __restrict__ b,
                                                                float* __restrict__ out, int N,
                                                                int iters) {
  extern __shared__ __align__(1024) unsigned char mma_smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  constexpr uint32_t kLbo = 128, kSbo = (kMmaK / 8) * 128;
  const int m0 = blockIdx.y * kMmaRows, n0 = blockIdx.x * NT;
  for (int e = threadIdx.x; e < NT * kMmaK; e += kMmaThreads) {
    const int n = e % NT, k = e / NT;
    bs[((n >> 3) * kSbo + (k >> 3) * kLbo + (n & 7) * 16) / 2 + (k & 7)] =
        b[static_cast<int64_t>(k) * N + n0 + n];
  }
  // the generic-proxy stores above must be visible to the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row = m0 + warp * 16 + g;
  uint32_t af[kMmaKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kMmaKSteps; ++ks) {
    const int col = ks * 16 + t4 * 2;
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(a + static_cast<int64_t>(row) * kMmaK + col);
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(a + static_cast<int64_t>(row + 8) * kMmaK + col);
    af[ks][0] = lo[0];
    af[ks][1] = hi[0];
    af[ks][2] = lo[4];
    af[ks][3] = hi[4];
  }
  const uint64_t desc = smem_desc(bs, kLbo, kSbo);
  float acc[NT / 2], d0[NT / 2], d1[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = d0[j] = d1[j] = 0.0f;
  uint32_t am0[kMmaKSteps][4], am1[kMmaKSteps][4];
  if (iters > 0) {
    // invariant at the loop's top: iteration i - 1 is in flight into d0
    add_index(am0, af, 0);
    issue_products<NT>(d0, am0, desc);
    int i = 1;
    for (; i + 1 < iters; i += 2) {
      add_index(am1, af, i);
      issue_products<NT>(d1, am1, desc);
      wgmma_wait<1>();
      add_products<NT>(acc, d0);
      add_index(am0, af, i + 1);
      issue_products<NT>(d0, am0, desc);
      wgmma_wait<1>();
      add_products<NT>(acc, d1);
    }
    if (i < iters) {
      add_index(am1, af, i);
      issue_products<NT>(d1, am1, desc);
      wgmma_wait<1>();
      add_products<NT>(acc, d0);
      wgmma_wait<0>();
      add_products<NT>(acc, d1);
    } else {
      wgmma_wait<0>();
      add_products<NT>(acc, d0);
    }
  }
  // accumulator layout: d[4 j + e] holds row g (e < 2) or g + 8, column 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * N + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(row + 8) * N + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- float32 product with fmaf -------------------------------------------------
// out (M, N) = sum_i (a + i) @ v, a (M, K), v (K, N) float32, on the FP32
// pipes (fmaf; no TF32, no tensor cores). Register-blocked: a thread keeps a
// 4 x 8 tile of out over a chunk of 8 k, with its 4 x 8 values of a and
// 8 x 8 of v in registers for the whole launch, so the loop reads no memory.
// An iteration forms a + i once for each of its 32 a values, runs 256 fmaf
// (4 rows x 8 columns x 8 k, the first k a multiply) into fresh partials and
// adds those to the thread's running float32 sums, 32 adds: 320 FP32
// instructions for 256 fmaf. K is split across threads and CTAs: a CTA of
// 128 threads takes 128 consecutive chunks (1024 of K) of one 4 x 8 tile,
// so M = 16, N = 128, K = 2048 gives 128 CTAs and N = 640 gives 640. After
// the loop a warp's xor butterfly adds its 32 chunks, the CTA adds its 4
// warps in order into split_out[s] (s the CTA's 1024-wide part of K), and a
// second launch adds the K / 1024 parts in order (no atomics).
constexpr int kFmRows = 4, kFmCols = 8, kFmK = 8, kFmThreads = 128;
constexpr int kFmKCta = kFmK * kFmThreads;  // 1024

__global__ void __launch_bounds__(kFmThreads) ffma_kernel(const float* __restrict__ a,
                                                          const float* __restrict__ v,
                                                          float* __restrict__ split_out, int M,
                                                          int K, int N, int iters) {
  const int r0 = blockIdx.y * kFmRows, c0 = blockIdx.x * kFmCols, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = s * kFmKCta + threadIdx.x * kFmK;
  float av[kFmRows][kFmK], vv[kFmK][kFmCols];
#pragma unroll
  for (int r = 0; r < kFmRows; ++r)
#pragma unroll
    for (int h = 0; h < kFmK; h += 4) {
      const float4 q = *reinterpret_cast<const float4*>(a + static_cast<int64_t>(r0 + r) * K + k0 + h);
      av[r][h] = q.x;
      av[r][h + 1] = q.y;
      av[r][h + 2] = q.z;
      av[r][h + 3] = q.w;
    }
#pragma unroll
  for (int kk = 0; kk < kFmK; ++kk)
#pragma unroll
    for (int h = 0; h < kFmCols; h += 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + static_cast<int64_t>(k0 + kk) * N + c0 + h);
      vv[kk][h] = q.x;
      vv[kk][h + 1] = q.y;
      vv[kk][h + 2] = q.z;
      vv[kk][h + 3] = q.w;
    }
  float acc[kFmRows][kFmCols];
#pragma unroll
  for (int r = 0; r < kFmRows; ++r)
#pragma unroll
    for (int c = 0; c < kFmCols; ++c) acc[r][c] = 0.0f;

  for (int i = 0; i < iters; ++i) {
    const float fi = static_cast<float>(i);
    float p[kFmRows][kFmCols];
#pragma unroll
    for (int kk = 0; kk < kFmK; ++kk) {
#pragma unroll
      for (int r = 0; r < kFmRows; ++r) {
        const float ap = av[r][kk] + fi;
#pragma unroll
        for (int c = 0; c < kFmCols; ++c) p[r][c] = kk == 0 ? ap * vv[0][c] : fmaf(ap, vv[kk][c], p[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFmRows; ++r)
#pragma unroll
      for (int c = 0; c < kFmCols; ++c) acc[r][c] = acc[r][c] + p[r][c];
  }

  __shared__ float warp_sums[kFmThreads / 32][kFmRows * kFmCols];
#pragma unroll
  for (int r = 0; r < kFmRows; ++r)
#pragma unroll
    for (int c = 0; c < kFmCols; ++c) {
      const float w = warp_sum(acc[r][c]);
      if (lane == 0) warp_sums[warp][r * kFmCols + c] = w;
    }
  __syncthreads();
  if (threadIdx.x < kFmRows * kFmCols) {
    const int e = threadIdx.x;
    float t = warp_sums[0][e];
#pragma unroll
    for (int w = 1; w < kFmThreads / 32; ++w) t = t + warp_sums[w][e];
    split_out[(static_cast<int64_t>(s) * M + r0 + e / kFmCols) * N + c0 + e % kFmCols] = t;
  }
}

// out[e] = sum_{s < S} split_out[s][e], s in order.
__global__ void __launch_bounds__(kThreads) split_sum_kernel(const float* __restrict__ split_out,
                                                             float* __restrict__ out, int n, int S) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float t = split_out[e];
  for (int s = 1; s < S; ++s) t = t + split_out[static_cast<int64_t>(s) * n + e];
  out[e] = t;
}

// The bfloat16 product's tile width for N: 80 where N is a multiple of 80,
// else 32 (0: N is neither).
int mma_cols(int N) { return N % kMmaWide == 0 ? kMmaWide : (N % kMmaNarrow == 0 ? kMmaNarrow : 0); }

size_t mma_smem_bytes(int nt) { return static_cast<size_t>(nt) * kMmaK * sizeof(__nv_bfloat16); }

const void* mma_kernel(int nt) {
  return nt == kMmaWide ? reinterpret_cast<const void*>(wgmma_bf16_kernel<kMmaWide>)
                        : reinterpret_cast<const void*>(wgmma_bf16_kernel<kMmaNarrow>);
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
    sublane_kernel<<<dim3(kLanes / kSubColsCta, rows / kLanes), kSubThreads, 0, s>>>(xf, of, iters);
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

// a (M, 128), b (128, N) bfloat16 -> out (M, N) float32; M % 64 == 0 and N a
// multiple of 80 or of 32.
extern "C" int o3dt_probe_mma_bf16(const void* a, const void* b, void* out, int M, int K, int N,
                                   int iters, void* stream) {
  const int nt = mma_cols(N);
  if (M % kMmaRows != 0 || M <= 0 || K != kMmaK || nt == 0) return cudaErrorInvalidValue;
  const dim3 grid(N / nt, M / kMmaRows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const __nv_bfloat16*>(a);
  const auto* bf = static_cast<const __nv_bfloat16*>(b);
  auto* of = static_cast<float*>(out);
  if (nt == kMmaWide) {
    wgmma_bf16_kernel<kMmaWide><<<grid, kMmaThreads, mma_smem_bytes(nt), s>>>(af, bf, of, N, iters);
  } else {
    wgmma_bf16_kernel<kMmaNarrow><<<grid, kMmaThreads, mma_smem_bytes(nt), s>>>(af, bf, of, N, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (M, K), v (K, N) float32 -> out (M, N) float32, through split_out
// (K / 1024, M, N) float32 scratch; M % 4, N % 8, K % 1024 == 0.
extern "C" int o3dt_probe_ffma(const void* a, const void* v, void* split_out, void* out, int M,
                               int K, int N, int iters, void* stream) {
  if (M % kFmRows != 0 || N % kFmCols != 0 || K % kFmKCta != 0 || M <= 0 || N <= 0 || K <= 0) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* so = static_cast<float*>(split_out);
  ffma_kernel<<<dim3(N / kFmCols, M / kFmRows, K / kFmKCta), kFmThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(v), so, M, K, N, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_sum_kernel<<<(M * N + kThreads - 1) / kThreads, kThreads, 0, s>>>(so, static_cast<float*>(out),
                                                                          M * N, K / kFmKCta);
  return static_cast<int>(cudaGetLastError());
}

// family 0: the bfloat16 product at width N; 1: the float32 product. out[0]
// CTAs a multiprocessor, out[1] multiprocessors, out[2] threads a CTA,
// out[3] registers a thread.
extern "C" int o3dt_probe_occupancy(int family, int N, int* out) {
  const void* kernel = reinterpret_cast<const void*>(ffma_kernel);
  size_t smem = 0;
  int threads = kFmThreads;
  if (family == 0) {
    const int nt = mma_cols(N);
    if (nt == 0) return cudaErrorInvalidValue;
    kernel = mma_kernel(nt);
    smem = mma_smem_bytes(nt);
    threads = kMmaThreads;
  } else if (family != 1) {
    return cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = threads;
  out[3] = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem));
}
