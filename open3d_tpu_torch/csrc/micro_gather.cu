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
// Design: every CTA stages the whole table into dynamic shared memory (160
// KB for R = 320 needs the opt-in above 48 KB), then walks the indices in a
// grid-stride loop, four at a time: a 16-byte streaming load of idx and a
// 16-byte streaming store of out, so device memory sees only full lines. The
// grid is as many CTAs as fit on the card at once (one a multiprocessor for
// the 160 KB table, up to eight for 16 KB), so the table is staged once per
// resident CTA, from L2 after the first. Random indices spread over the 32
// banks, about three-way conflicts a load.
//
// An index outside [0, R * 128) stops the kernel with a device fault
// (__trap, reported at the next synchronisation): it never reads outside
// the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pick(const float* tab, int i, int n_table) {
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(n_table)) __trap();
  return tab[i];
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const float* __restrict__ table,
                                                          const int32_t* __restrict__ idx,
                                                          float* __restrict__ out, int n_table,
                                                          int64_t n) {
  extern __shared__ float tab[];
  const float4* t4 = reinterpret_cast<const float4*>(table);
  float4* s4 = reinterpret_cast<float4*>(tab);
  for (int j = threadIdx.x; j < n_table / 4; j += kThreads) s4[j] = t4[j];
  __syncthreads();

  const int64_t n4 = n / 4;
  const int4* i4 = reinterpret_cast<const int4*>(idx);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; q < n4; q += stride) {
    const int4 v = __ldcs(i4 + q);
    __stcs(o4 + q, make_float4(pick(tab, v.x, n_table), pick(tab, v.y, n_table),
                               pick(tab, v.z, n_table), pick(tab, v.w, n_table)));
  }
  if (blockIdx.x == 0) {
    for (int64_t s = n4 * 4 + threadIdx.x; s < n; s += kThreads) out[s] = pick(tab, idx[s], n_table);
  }
}

}  // namespace

extern "C" int o3dt_micro_gather(const void* table, const void* idx, void* out, int R,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const int n_table = R * 128;
  const size_t smem = static_cast<size_t>(n_table) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n / 4 + kThreads - 1) / kThreads;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (need < grid) grid = static_cast<int>(need > 0 ? need : 1);
  gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_table, static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
