// Tracking's two depth filters, each one stencil launch: the edge-preserving
// bilateral filter of a depth image and the depth-aware 5x5 pyrdown.
//
// Replaces the _shift2d loops of open3d_tpu_torch/geometry/image.py:
// filter_bilateral_depth and pyrdown_depth (the same functions as
// open3d_tpu/geometry/image.py's, which XLA fuses; no Pallas kernel), whose
// every tap was ~22 eager PyTorch operations and a host-to-device scalar.
//
// Bound: an output pixel reads its k x k neighbourhood (25 taps at the
// defaults) and writes one float: 4 B in and 4 B out a pixel from device
// memory, since a row's neighbours are served again from L1 and L2 (a
// 640x480 image is 1.2 MB of the 50 MB L2). By count the bilateral filter
// is bound by operations (10 a tap, an expf as one), the pyrdown by bytes.
// The bilateral filter's two expf a tap set its time in practice; either
// kernel takes microseconds where the loops it replaces took ~580
// launches. Design: one thread a pixel over a 1-D grid of 256-thread CTAs
// (a CTA is a run of 256 pixels of one or two rows; the rows above and
// below come through the read-only cache), no shared memory, so any kernel
// size and image shape take the same code.
//
// Rounding: the plain versions' element-wise operations in their order, so
// the output is bit-equal to theirs run on the same card. Taps go dy outer,
// dx inner, each from -r to r; a tap reads depth(y - dy, x - dx), 0 outside
// the image (_shift2d's fill). Every product and sum rounds on its own (the
// library is built with --fmad=false), expf is the accurate one PyTorch's
// CUDA exp calls, the division is IEEE's, and a mask multiplies as 0.0f or
// 1.0f, as a bool tensor times a float tensor does. Scalars that PyTorch
// takes as float32 arrive as float: 1 / (2 sigma_depth^2) and the pyrdown
// threshold. The space weight's argument is the float32 rounding of
// -(dy^2 + dx^2) * 1 / (2 sigma_space^2) taken in double, as Python computes
// it before torch.tensor rounds it; the pyrdown's five Gaussian weights are
// read from the device tensor that the plain version computes (torch.sum's
// order is not this file's).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const float* __restrict__ in, int H, int W, int y, int x) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(in + y * W + x) : 0.0f;
}

// PyTorch's clamp(min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__global__ void __launch_bounds__(kThreads) bilateral_kernel(const float* __restrict__ in,
                                                             float* __restrict__ out, int H, int W,
                                                             int r, double inv2ss, float inv2sd) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int y = p / W, x = p - y * W;
  const float d = __ldg(in + p);
  float num = 0.0f, den = 0.0f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      const float nb = tap(in, H, W, y - dy, x - dx);
      const float w_s = expf(static_cast<float>(static_cast<double>(-(dy * dy + dx * dx)) * inv2ss));
      const float diff = nb - d;
      const float w = (w_s * expf(-(diff * diff) * inv2sd)) * (nb > 0.0f ? 1.0f : 0.0f);
      num = num + w * nb;
      den = den + w;
    }
  }
  const float o = num / clamp_min(den, 1e-8f);
  out[p] = d > 0.0f ? o : 0.0f;
}

// Output pixel (yo, xo) is the smoothed input pixel (2 yo, 2 xo): the plain
// version's [::2, ::2] of the whole smoothed image, computed only where kept.
__global__ void __launch_bounds__(kThreads) pyrdown_kernel(const float* __restrict__ in,
                                                           const float* __restrict__ k5,
                                                           float* __restrict__ out, int H, int W,
                                                           int Wo, int n_out, float thr) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n_out) return;
  const int yo = q / Wo;
  const int y = 2 * yo, x = 2 * (q - yo * Wo);
  const float d = __ldg(in + y * W + x);
  float k[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) k[i] = __ldg(k5 + i);
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float nb = tap(in, H, W, y - (i - 2), x - (j - 2));
      const float w = ((k[i] * k[j]) * (nb > 0.0f ? 1.0f : 0.0f)) *
                      (fabsf(nb - d) < thr ? 1.0f : 0.0f);
      num = num + w * nb;
      den = den + w;
    }
  }
  const float o = num / clamp_min(den, 1e-8f);
  out[q] = d > 0.0f ? o : 0.0f;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// out (H, W) = the bilateral filter of in (H, W) at radius r.
extern "C" int o3dt_bilateral_depth(const void* in, void* out, int H, int W, int r, double inv2ss,
                                    float inv2sd, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  bilateral_kernel<<<blocks(H * W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), H, W, r, inv2ss, inv2sd);
  return static_cast<int>(cudaGetLastError());
}

// out (ceil(H/2), ceil(W/2)) = the depth-aware pyrdown of in (H, W) with the
// Gaussian weights k5 (5,) on the device.
extern "C" int o3dt_pyrdown_depth(const void* in, const void* k5, void* out, int H, int W,
                                  float thr, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const int Wo = (W + 1) / 2, n_out = ((H + 1) / 2) * Wo;
  pyrdown_kernel<<<blocks(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(k5), static_cast<float*>(out), H, W,
      Wo, n_out, thr);
  return static_cast<int>(cudaGetLastError());
}
