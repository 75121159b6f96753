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
// Design: four CTAs of 256 threads per work-list entry (a quarter of the
// block each; entries whose slot is the dump row C exit at once). A thread
// owns one 16-byte group of its rows: 4 x-consecutive voxels, group
// q = tid + 256 * quarter. It projects its 4 voxels (the pixel depends on
// the voxel's position only, never on the old payload) and issues, in one
// burst, every frame gather (d21 and rgb24 for K1; the five bf16 planes
// for K4, colour only for a colour grid) together with the 16-byte loads of
// its tw and colour words; only then does it compute, and it writes back
// with two 16-byte stores. A thread reads the frame directly: there are no
// slab windows and no second pass, every block is covered in one launch.
// The SASS (cuobjdump -sass on sm_90a) issues both row loads and all frame
// gathers before the first instruction that uses one of them.
//
// Bound: bytes. Each touched block reads and writes its 16 KiB tw row and
// its 16 KiB colour row (64 KiB a block), plus gathers from the frame (two
// 4-byte images for K1, five 2-byte planes for K4). At the SLAM workload
// (about 580 live blocks) that is too little work to fill the card at one
// load in flight a thread, so the kernel is bound by memory latency and by
// the bytes a multiprocessor keeps in flight: a voxel's frame gathers and
// row loads go out together, one round trip a voxel. Four voxels a thread
// keep the burst in few registers (48 for K1, 58 for K4), so a
// multiprocessor holds 5 (K1) or 4 (K4) CTAs and the tail over the ~2300
// live quarters is short; a burst of 16 voxels a thread needs 100 and 136
// registers, 2 and 1 CTAs, and is slower.
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

// The V1 relayout's split of a float32 into bf16 hi + lo words, re-summed.
__device__ __forceinline__ float hi_lo(float x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
  return hi + lo;
}

constexpr int kParts = 4;  // CTAs a work-list entry: a quarter of the block each

__device__ __forceinline__ int32_t lane(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The camera-frame position of voxel e of 16-byte group q (voxels 4q..4q+3,
// x-consecutive) of the block whose world origin is (bxf, byf, bzf).
template <bool kV1>
__device__ __forceinline__ void project(const float* R, float bxf, float byf, float bzf,
                                        float voxel_size, int q, int e, float* pcx, float* pcy,
                                        float* pcz) {
  const float lx = static_cast<float>(4 * (q & 3) + e);
  const float ly = static_cast<float>((q >> 2) & 15);
  const float lz = static_cast<float>(q >> 6);
  const float pwx = fmaf(lx, voxel_size, bxf);
  const float pwy = fmaf(ly, voxel_size, byf);
  const float pwz = fmaf(lz, voxel_size, bzf);
  if (kV1) {
    *pcx = fmaf(R[2], pwz, fmaf(R[0], pwx, R[1] * pwy)) + R[9];
    *pcy = fmaf(R[5], pwz, fmaf(R[3], pwx, R[4] * pwy)) + R[10];
    *pcz = fmaf(R[8], pwz, fmaf(R[6], pwx, R[7] * pwy)) + R[11];
  } else {
    *pcx = fmaf(R[0], pwx, R[1] * pwy) + R[2] * pwz + R[9];
    *pcy = fmaf(R[3], pwx, R[4] * pwy) + R[5] * pwz + R[10];
    *pcz = fmaf(R[6], pwx, R[7] * pwy) + R[8] * pwz + R[11];
  }
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
  const int g = blockIdx.x / kParts;
  const int q = threadIdx.x + kThreads * (blockIdx.x % kParts);
  const int slot = slots[g];
  if (slot < 0 || slot >= C) return;  // failed activation -> dump row: skip

  float R[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) R[i] = params[i];
  const float bxf = static_cast<float>(coords[3 * g + 0]) * block_size;
  const float byf = static_cast<float>(coords[3 * g + 1]) * block_size;
  const float bzf = static_cast<float>(coords[3 * g + 2]) * block_size;
  const int64_t HW = static_cast<int64_t>(H) * W;

  int4* row_tw = reinterpret_cast<int4*>(tw + static_cast<int64_t>(slot) * kB3);
  int4* row_col = color ? reinterpret_cast<int4*>(color + static_cast<int64_t>(slot) * kB3)
                        : nullptr;

  // ---- the burst: every load of the thread's 4 voxels before any use
  const int4 otw = row_tw[q];
  const int4 ocol = row_col ? row_col[q] : make_int4(0, 0, 0, 0);
  // K1: d21 and rgb24 words; K4: d_hi, d_lo, r, g, b bf16 words
  uint32_t s0[4], s1[4], s2[4], s3[4], s4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float pcx, pcy, pcz;
    project<kV1>(R, bxf, byf, bzf, voxel_size, q, e, &pcx, &pcy, &pcz);
    const float zc = fmaxf(pcz, 1e-6f);
    const int ui = __float2int_rn(fmaf(pcx / zc, fx, cx));
    const int vi = __float2int_rn(fmaf(pcy / zc, fy, cy));
    const bool inb = (pcz > 1e-4f) && ui >= 0 && ui < W && vi >= 0 && vi < H;
    const int lin = inb ? vi * W + ui : 0;
    if (kV1) {
      s0[e] = inb ? planes[lin] : 0u;
      s1[e] = inb ? planes[HW + lin] : 0u;
      const bool col = inb && row_col;  // colour samples only for a colour grid
      s2[e] = col ? planes[2 * HW + lin] : 0u;
      s3[e] = col ? planes[3 * HW + lin] : 0u;
      s4[e] = col ? planes[4 * HW + lin] : 0u;
    } else {
      s0[e] = inb ? static_cast<uint32_t>(d21[lin]) : 0u;
      s1[e] = (inb && rgb24) ? static_cast<uint32_t>(rgb24[lin]) : 0u;
      s2[e] = s3[e] = s4[e] = 0u;
    }
  }

  // ---- compute, then write back with two 16-byte stores
  int32_t ntw[4], ncol[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float pcx, pcy, pcz;
    project<kV1>(R, bxf, byf, bzf, voxel_size, q, e, &pcx, &pcy, &pcz);
    // an out-of-frame voxel loaded 0 words: d = 0, as the JAX kernel's
    const float d = kV1 ? __uint_as_float(s0[e] << 16) + __uint_as_float(s1[e] << 16)
                        : static_cast<float>(static_cast<int32_t>(s0[e])) * d21_scale;
    const bool d_ok = (d > 0.0f) && (d < depth_max);
    const float sdf = d - pcz;
    const bool keep = d_ok && (sdf >= neg_trunc);
    const float tsdf_new = clipf(sdf * inv_trunc, -1.0f, 1.0f);
    const float w_n = keep ? 1.0f : 0.0f;

    const int32_t old = lane(otw, e);
    const float old_t = static_cast<float>(old >> 16) * (1.0f / kTsdfScale);
    const float old_w = static_cast<float>(old & 0xFFFF);
    const float w_sum = old_w + w_n;
    const float inv = 1.0f / fmaxf(w_sum, 1e-6f);
    const bool upd = w_n > 0.0f;
    const float t_new = kV1 ? hi_lo(keep ? tsdf_new : 0.0f) : (keep ? tsdf_new : 0.0f);
    const float t2 = upd ? fmaf(old_t, old_w, t_new * w_n) * inv : old_t;
    const float w2 = fminf(w_sum, weight_max);
    const int tq = __float2int_rn(clipf(t2, -1.0f, 1.0f) * kTsdfScale);
    ntw[e] = static_cast<int32_t>((static_cast<uint32_t>(tq) << 16) |
                                  static_cast<uint32_t>(static_cast<int32_t>(w2)));

    const int32_t oldc = lane(ocol, e);
    const float ro = static_cast<float>((oldc >> 21) & 0x7FF) * (1.0f / 2047.0f);
    const float go = static_cast<float>((oldc >> 10) & 0x7FF) * (1.0f / 2047.0f);
    const float bo = static_cast<float>(oldc & 0x3FF) * (1.0f / 1023.0f);
    float rn = 0.0f, gn = 0.0f, bn = 0.0f;
    if (keep) {
      if (kV1) {
        rn = __uint_as_float(s2[e] << 16);
        gn = __uint_as_float(s3[e] << 16);
        bn = __uint_as_float(s4[e] << 16);
      } else {
        const int32_t cq = static_cast<int32_t>(s1[e]);
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
    ncol[e] = (ri << 21) | (gi << 10) | bi;
  }
  row_tw[q] = make_int4(ntw[0], ntw[1], ntw[2], ntw[3]);
  if (row_col) row_col[q] = make_int4(ncol[0], ncol[1], ncol[2], ncol[3]);
}

}  // namespace

extern "C" int o3dt_integrate_blocks(
    void* tw, void* color, const void* slots, const void* coords, int M, int C,
    const void* d21, const void* rgb24, int H, int W, const void* params,
    float fx, float fy, float cx, float cy, float voxel_size, float block_size,
    float neg_trunc, float inv_trunc, float depth_max, float d21_scale,
    float weight_max, void* stream) {
  if (M <= 0) return 0;
  integrate_kernel<false><<<M * kParts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  integrate_kernel<true><<<M * kParts, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tw), static_cast<int32_t*>(color),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(coords), C, nullptr,
      nullptr, static_cast<const uint16_t*>(planes), H, W, static_cast<const float*>(params),
      fx, fy, cx, cy, voxel_size, block_size, neg_trunc, inv_trunc, depth_max, 0.0f,
      weight_max);
  return static_cast<int>(cudaGetLastError());
}
