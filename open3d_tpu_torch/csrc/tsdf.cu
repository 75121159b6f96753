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
// Design: one CTA per work-list entry; entries whose row is the dump row C
// are skipped (the caller re-zeroes row C). 128 threads stride over the B^3
// voxels of the row, so any block resolution works (512 voxels, 4 a
// thread, for the 8^3 fragment grids), and every load and store of a row
// is coalesced.
//
// Bound: bytes. A live row reads three 4-byte samples and two 4-byte words a
// voxel and writes the two words back: 28 B a voxel with colour, against
// ~30 float32 operations. Each word is read once and written once; nothing
// is staged.
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

template <bool kColor>
__global__ void __launch_bounds__(kThreads) fuse_kernel(
    int32_t* __restrict__ tw, int32_t* __restrict__ color,
    const int32_t* __restrict__ rows, const float* __restrict__ tsdf_new,
    const float* __restrict__ wn, const int32_t* __restrict__ cnew, int C, int B3,
    float weight_max) {
  const int g = blockIdx.x;
  const int row = rows[g];
  if (row < 0 || row >= C) return;  // dump row: skip
  int32_t* row_tw = tw + static_cast<int64_t>(row) * B3;
  int32_t* row_col = kColor ? color + static_cast<int64_t>(row) * B3 : nullptr;
  const int64_t base = static_cast<int64_t>(g) * B3;

  for (int f = threadIdx.x; f < B3; f += kThreads) {
    const int32_t old = row_tw[f];
    const float old_t = static_cast<float>(old >> 16) * (1.0f / kTsdfScale);
    const float old_w = static_cast<float>(old & 0xFFFF);
    const float w_n = wn[base + f];
    const float w_sum = old_w + w_n;
    const bool upd = w_n > 0.0f;
    const float num = old_t * old_w + tsdf_new[base + f] * w_n;
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
    row_tw[f] = static_cast<int32_t>((static_cast<uint32_t>(tq) << 16) |
                                     static_cast<uint32_t>(static_cast<int32_t>(w2)));
    if (kColor) {
      const int32_t oc = row_col[f];
      const int32_t nc = cnew[base + f];
      const float ro = static_cast<float>((oc >> 21) & 0x7FF) * (1.0f / 2047.0f);
      const float go = static_cast<float>((oc >> 10) & 0x7FF) * (1.0f / 2047.0f);
      const float bo = static_cast<float>(oc & 0x3FF) * (1.0f / 1023.0f);
      const float rn = static_cast<float>((nc >> 21) & 0x7FF) * (1.0f / 2047.0f);
      const float gn = static_cast<float>((nc >> 10) & 0x7FF) * (1.0f / 2047.0f);
      const float bn = static_cast<float>(nc & 0x3FF) * (1.0f / 1023.0f);
      const float r2 = upd ? (ro * old_w + rn * w_n) * inv : ro;
      const float g2 = upd ? (go * old_w + gn * w_n) * inv : go;
      const float b2 = upd ? (bo * old_w + bn * w_n) * inv : bo;
      row_col[f] = pack_rgb(r2, g2, b2);
    }
  }
}

}  // namespace

extern "C" int o3dt_fuse_blocks(void* tw, void* color, const void* rows,
                                const void* tsdf_new, const void* wn, const void* cnew,
                                int M, int C, int B3, float weight_max, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (color != nullptr) {
    fuse_kernel<true><<<M, kThreads, 0, s>>>(
        static_cast<int32_t*>(tw), static_cast<int32_t*>(color),
        static_cast<const int32_t*>(rows), static_cast<const float*>(tsdf_new),
        static_cast<const float*>(wn), static_cast<const int32_t*>(cnew), C, B3, weight_max);
  } else {
    fuse_kernel<false><<<M, kThreads, 0, s>>>(
        static_cast<int32_t*>(tw), nullptr, static_cast<const int32_t*>(rows),
        static_cast<const float*>(tsdf_new), static_cast<const float*>(wn), nullptr, C, B3,
        weight_max);
  }
  return static_cast<int>(cudaGetLastError());
}
