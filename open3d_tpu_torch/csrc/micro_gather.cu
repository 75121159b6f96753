// Gather from a small table held in shared memory: out[s] = table.flat[idx[s]].
//
// Replaces scripts/micro_onehot_gather.py:make_gather (the pallas_call at
// :49) and computes its function, which both of its variants ("take" and
// "reduce") compute: the TPU selects the table row with a one-hot matrix
// product and then the lane with take_along_axis or a masked sum. A Hopper
// thread reads the word from shared memory directly, so one kernel serves
// both variants; the script's S_CHUNK, a TPU grid size, only names which
// configuration runs.
//
// Bound: bytes. Each index is read once (4 B) and each output written once
// (4 B), and the table (R x 128 float32, 16 KB or 160 KB) once: NT * 8 +
// R * 512 bytes, about 96 MB for the script's 12 M indices, against one
// shared-memory load per index and no arithmetic.
//
// Design: the grid is as many CTAs as fit on the card at once, each with
// the whole table in dynamic shared memory (160 KB for R = 320 needs the
// opt-in above 48 KB, and leaves room for one CTA a multiprocessor). The
// indices stream through in a grid-stride loop, four at a time: a 16-byte
// streaming load of idx and a 16-byte streaming store of out, so device
// memory sees only full lines. A stream this long runs at the memory's rate
// only with enough bytes in flight a multiprocessor (about 3.35 TB/s x 0.6
// us / 132 = 15 KB), so a CTA is 1024 threads and each thread issues kU
// independent 16-byte index loads before its first lookup: 64 KB in flight
// a multiprocessor at kU = 4 even when only one CTA fits. The table does
// not hold the first loads back: one thread starts its copy into shared
// memory as Tensor Memory Accelerator bulk copies (cp.async.bulk, global to
// shared) that complete on an mbarrier, every thread issues its first kU
// index loads, and only then waits on the barrier. Random indices spread
// over the 32 banks, about three-way conflicts a load.
//
// Other layouts were timed on the card and are no faster: two loads a
// thread, 512 or 256 threads a CTA, the table staged by the threads behind
// a barrier; PERF.md records what they took.
//
// An index outside [0, R * 128) stops the kernel with a device fault
// (__trap, reported at the next synchronisation): it never reads outside
// the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kU = 4;                  // 16-byte index loads a thread issues before a lookup
constexpr uint32_t kCopyBytes = 16384;  // bytes of one bulk copy of the table

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float pick(const float* tab, int i, int n_table) {
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(n_table)) __trap();
  return tab[i];
}

// Shared memory: the table (n_table floats), then the copy's mbarrier.
__global__ void __launch_bounds__(kThreads) gather_kernel(const float* __restrict__ table,
                                                          const int32_t* __restrict__ idx,
                                                          float* __restrict__ out, int n_table,
                                                          int64_t n) {
  extern __shared__ __align__(128) float tab[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(tab + n_table);
  const uint32_t table_bytes = static_cast<uint32_t>(n_table) * 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, table_bytes);
    for (uint32_t off = 0; off < table_bytes; off += kCopyBytes) {
      const uint32_t len = table_bytes - off < kCopyBytes ? table_bytes - off : kCopyBytes;
      bulk_copy_g2s(reinterpret_cast<char*>(tab) + off,
                    reinterpret_cast<const char*>(table) + off, len, bar);
    }
  }
  bool staged = false;

  const int64_t n4 = n / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; q0 < n4;
       q0 += stride * kU) {
    int4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t q = q0 + u * stride;
      if (q < n4) v[u] = __ldcs(i4 + q);
    }
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t q = q0 + u * stride;
      if (q < n4) {
        __stcs(o4 + q, make_float4(pick(tab, v[u].x, n_table), pick(tab, v[u].y, n_table),
                                   pick(tab, v[u].z, n_table), pick(tab, v[u].w, n_table)));
      }
    }
  }
  // the CTA's shared memory must outlive its copy, and block 0 needs the
  // table for the tail
  if (!staged && (threadIdx.x == 0 || blockIdx.x == 0)) mbar_wait(bar, 0);
  if (blockIdx.x == 0) {
    for (int64_t s = n4 * 4 + threadIdx.x; s < n; s += kThreads)
      out[s] = pick(tab, idx[s], n_table);
  }
}

// Opt in to the table's shared memory; then the CTAs a multiprocessor holds,
// the multiprocessors and the registers a thread.
cudaError_t occupancy(int n_table, size_t* smem, int* per_sm, int* sms, int* regs) {
  *smem = static_cast<size_t>(n_table) * sizeof(float) + 16;
  cudaError_t err = cudaFuncSetAttribute(gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gather_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gather_kernel, kThreads, *smem);
}

}  // namespace

extern "C" int o3dt_micro_gather(const void* table, const void* idx, void* out, int R,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const int n_table = R * 128;
  size_t smem = 0;
  int per_sm = 0, sms = 0, regs = 0;
  const cudaError_t err = occupancy(n_table, &smem, &per_sm, &sms, &regs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_cta = int64_t{kThreads} * kU;
  const int64_t need = (n / 4 + per_cta - 1) / per_cta;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (need < grid) grid = static_cast<int>(need > 0 ? need : 1);
  gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx), static_cast<float*>(out),
      n_table, static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

// For a table of R rows: out[0] CTAs a multiprocessor, out[1]
// multiprocessors, out[2] threads a CTA, out[3] registers a thread.
extern "C" int o3dt_micro_gather_occupancy(int R, int* out) {
  size_t smem = 0;
  out[2] = kThreads;
  return static_cast<int>(occupancy(R * 128, &smem, &out[0], &out[1], &out[3]));
}
