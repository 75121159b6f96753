// Fused TSDF integrate of the touched 16^3 blocks, in place, in two sample
// formats chosen at compile time (one template, two entry points):
// - K1, o3dt_integrate_blocks: replaces
//   open3d_tpu/ops/pallas/integrate2.py:_integrate_kernel_v2, sampling a
//   d21-quantised depth image and an rgb24 colour image;
// - K4, o3dt_integrate_blocks_v1: replaces
//   open3d_tpu/ops/pallas/integrate.py:_integrate_kernel, sampling (5, H, W)
//   bf16 planes [d_hi | d_lo | r | g | b] (depth = d_hi + d_lo, ~17 bits)
//   and passing the new tsdf through the V1 kernel's relayout split,
//   t' = f32(bf16(t)) + f32(bf16(t - f32(bf16(t)))). Its one-hot MXU
//   selects, shifted plane copy, slab windows and fit flags are TPU
//   mechanics and are not reproduced: every block integrates.
//
// Both compute the same function: world -> camera (R, t), the pixel by
// half-to-even rounding, the depth and colour samples at that pixel,
// keep = in frame && 0 < d < depth_max && sdf >= -trunc, tsdf =
// clip(sdf / trunc), running weighted mean with the weight_max clamp, and
// the s1.14 | u16 and R11|G11|B10 repack of the payload row.
//
// Design: one CTA per work-list entry (entries whose slot is the dump row C
// are skipped), 256 threads, 16 voxels a thread at flat = tid + 256 i, so
// every load and store of a payload row is coalesced. A thread reads the
// depth and colour images directly: there are no slab windows and no
// second pass, every block is covered in one launch.
//
// Bound: bytes. Each touched block reads and writes its 16 KiB tw row and
// its 16 KiB colour row (64 KiB a block), plus gathers from the frame (two
// 4-byte images for K1, five 2-byte planes for K4). The design reads each
// row once and writes it once and keeps everything else in registers.
//
// Arithmetic follows the JAX kernels' order element by element. Multiply-adds
// are fused (fmaf) exactly where XLA's CPU backend fuses them in the
// interpreted JAX kernels, the reference of the CPU tests (the projection
// rows differ between the two: K4 fuses both product pairs); the file is
// built with --fmad=false so no other product is fused, and pixels round
// with __float2int_rn (ties to even, as jnp.round). So each mode agrees bit
// for bit with its plain version (integrate_blocks_plain,
// integrate_blocks_plain_v1), which fuses at the same places.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB3 = 4096;
constexpr int kThreads = 256;
constexpr float kTsdfScale = 16383.0f;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float bf16_at(const uint16_t* __restrict__ p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}

// The V1 relayout's split of a float32 into bf16 hi + lo words, re-summed.
__device__ __forceinline__ float hi_lo(float x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
  return hi + lo;
}

template <bool kV1>
__global__ void __launch_bounds__(kThreads) integrate_kernel(
    int32_t* __restrict__ tw, int32_t* __restrict__ color,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ coords,
    int C, const int32_t* __restrict__ d21, const int32_t* __restrict__ rgb24,
    const uint16_t* __restrict__ planes,
    int H, int W, const float* __restrict__ params,
    float fx, float fy, float cx, float cy,
    float voxel_size, float block_size, float neg_trunc, float inv_trunc,
    float depth_max, float d21_scale, float weight_max) {
  const int g = blockIdx.x;
  const int slot = slots[g];
  if (slot < 0 || slot >= C) return;  // failed activation -> dump row: skip

  const float R00 = params[0], R01 = params[1], R02 = params[2];
  const float R10 = params[3], R11 = params[4], R12 = params[5];
  const float R20 = params[6], R21 = params[7], R22 = params[8];
  const float tX = params[9], tY = params[10], tZ = params[11];
  const float bxf = static_cast<float>(coords[3 * g + 0]) * block_size;
  const float byf = static_cast<float>(coords[3 * g + 1]) * block_size;
  const float bzf = static_cast<float>(coords[3 * g + 2]) * block_size;

  int32_t* row_tw = tw + static_cast<int64_t>(slot) * kB3;
  int32_t* row_col = color ? color + static_cast<int64_t>(slot) * kB3 : nullptr;

#pragma unroll 4
  for (int i = 0; i < kB3 / kThreads; ++i) {
    const int f = threadIdx.x + kThreads * i;
    const float lx = static_cast<float>(f & 15);
    const float ly = static_cast<float>((f >> 4) & 15);
    const float lz = static_cast<float>(f >> 8);
    const float pwx = fmaf(lx, voxel_size, bxf);
    const float pwy = fmaf(ly, voxel_size, byf);
    const float pwz = fmaf(lz, voxel_size, bzf);
    float pcx, pcy, pcz;
    if (kV1) {
      pcx = fmaf(R02, pwz, fmaf(R00, pwx, R01 * pwy)) + tX;
      pcy = fmaf(R12, pwz, fmaf(R10, pwx, R11 * pwy)) + tY;
      pcz = fmaf(R22, pwz, fmaf(R20, pwx, R21 * pwy)) + tZ;
    } else {
      pcx = fmaf(R00, pwx, R01 * pwy) + R02 * pwz + tX;
      pcy = fmaf(R10, pwx, R11 * pwy) + R12 * pwz + tY;
      pcz = fmaf(R20, pwx, R21 * pwy) + R22 * pwz + tZ;
    }
    const float zc = fmaxf(pcz, 1e-6f);
    const int ui = __float2int_rn(fmaf(pcx / zc, fx, cx));
    const int vi = __float2int_rn(fmaf(pcy / zc, fy, cy));
    const bool inb = (pcz > 1e-4f) && ui >= 0 && ui < W && vi >= 0 && vi < H;
    const int64_t HW = static_cast<int64_t>(H) * W;
    const int lin = inb ? vi * W + ui : 0;
    float d = 0.0f;
    int32_t cq = 0;
    if (inb) {
      if (kV1) {
        d = bf16_at(planes, lin) + bf16_at(planes, HW + lin);
      } else {
        d = static_cast<float>(d21[lin]) * d21_scale;
        if (rgb24) cq = rgb24[lin];
      }
    }
    const bool d_ok = (d > 0.0f) && (d < depth_max);
    const float sdf = d - pcz;
    const bool keep = d_ok && (sdf >= neg_trunc);
    const float tsdf_new = clipf(sdf * inv_trunc, -1.0f, 1.0f);
    const float w_n = keep ? 1.0f : 0.0f;

    const int32_t old = row_tw[f];
    const float old_t = static_cast<float>(old >> 16) * (1.0f / kTsdfScale);
    const float old_w = static_cast<float>(old & 0xFFFF);
    const float w_sum = old_w + w_n;
    const float inv = 1.0f / fmaxf(w_sum, 1e-6f);
    const bool upd = w_n > 0.0f;
    const float t_new = kV1 ? hi_lo(keep ? tsdf_new : 0.0f) : (keep ? tsdf_new : 0.0f);
    const float t2 = upd ? fmaf(old_t, old_w, t_new * w_n) * inv : old_t;
    const float w2 = fminf(w_sum, weight_max);
    const int tq = __float2int_rn(clipf(t2, -1.0f, 1.0f) * kTsdfScale);
    row_tw[f] = static_cast<int32_t>((static_cast<uint32_t>(tq) << 16) |
                                     static_cast<uint32_t>(static_cast<int32_t>(w2)));

    if (row_col) {
      const int32_t oldc = row_col[f];
      const float ro = static_cast<float>((oldc >> 21) & 0x7FF) * (1.0f / 2047.0f);
      const float go = static_cast<float>((oldc >> 10) & 0x7FF) * (1.0f / 2047.0f);
      const float bo = static_cast<float>(oldc & 0x3FF) * (1.0f / 1023.0f);
      float rn = 0.0f, gn = 0.0f, bn = 0.0f;
      if (keep) {
        if (kV1) {
          rn = bf16_at(planes, 2 * HW + lin);
          gn = bf16_at(planes, 3 * HW + lin);
          bn = bf16_at(planes, 4 * HW + lin);
        } else {
          rn = static_cast<float>((cq >> 16) & 0xFF) * (1.0f / 255.0f);
          gn = static_cast<float>((cq >> 8) & 0xFF) * (1.0f / 255.0f);
          bn = static_cast<float>(cq & 0xFF) * (1.0f / 255.0f);
        }
      }
      const float r2 = upd ? fmaf(ro, old_w, rn * w_n) * inv : ro;
      const float g2 = upd ? fmaf(go, old_w, gn * w_n) * inv : go;
      const float b2 = upd ? fmaf(bo, old_w, bn * w_n) * inv : bo;
      // +0.5 then truncate, as the JAX kernel does (not pack_rgb's round)
      const int ri = static_cast<int>(clipf(fmaf(r2, 2047.0f, 0.5f), 0.0f, 2047.0f));
      const int gi = static_cast<int>(clipf(fmaf(g2, 2047.0f, 0.5f), 0.0f, 2047.0f));
      const int bi = static_cast<int>(clipf(fmaf(b2, 1023.0f, 0.5f), 0.0f, 1023.0f));
      row_col[f] = (ri << 21) | (gi << 10) | bi;
    }
  }
}

}  // namespace

extern "C" int o3dt_integrate_blocks(
    void* tw, void* color, const void* slots, const void* coords, int M, int C,
    const void* d21, const void* rgb24, int H, int W, const void* params,
    float fx, float fy, float cx, float cy, float voxel_size, float block_size,
    float neg_trunc, float inv_trunc, float depth_max, float d21_scale,
    float weight_max, void* stream) {
  if (M <= 0) return 0;
  integrate_kernel<false><<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tw), static_cast<int32_t*>(color),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(coords), C,
      static_cast<const int32_t*>(d21), static_cast<const int32_t*>(rgb24), nullptr, H, W,
      static_cast<const float*>(params), fx, fy, cx, cy, voxel_size, block_size,
      neg_trunc, inv_trunc, depth_max, d21_scale, weight_max);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int o3dt_integrate_blocks_v1(
    void* tw, void* color, const void* slots, const void* coords, int M, int C,
    const void* planes, int H, int W, const void* params, float fx, float fy, float cx,
    float cy, float voxel_size, float block_size, float neg_trunc, float inv_trunc,
    float depth_max, float weight_max, void* stream) {
  if (M <= 0) return 0;
  integrate_kernel<true><<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tw), static_cast<int32_t*>(color),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(coords), C, nullptr,
      nullptr, static_cast<const uint16_t*>(planes), H, W, static_cast<const float*>(params),
      fx, fy, cx, cy, voxel_size, block_size, neg_trunc, inv_trunc, depth_max, 0.0f,
      weight_max);
  return static_cast<int>(cudaGetLastError());
}
