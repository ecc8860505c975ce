// Per-row helpers shared by the fused preprocesses, preprocess.cu (3DGS)
// and surfel_preprocess.cu (2DGS surfels): PyTorch's rounding of Python
// scalars, its NaN-propagating clamps, the tile index of a binning rect,
// and the SH colour of core/sh.py:eval_sh, each op for op as the plain
// versions run them on the card. Every source is built with -fmad=false,
// so nothing here is contracted into a multiply-add.

#pragma once

#include <cuda_runtime.h>

namespace prep {

constexpr int kTile = 16;
constexpr float kInvTile = 1.0f / kTile;  // PyTorch divides by a scalar as x * (1 / s)

// A Python float as PyTorch applies it to a float32 tensor: the double,
// rounded to float.
__host__ __device__ constexpr float f32(double v) { return static_cast<float>(v); }

// core/sh.py's constants
constexpr float kC0 = f32(0.28209479177387814);
constexpr float kC1 = f32(0.4886025119029199);
constexpr float kC2_0 = f32(1.0925484305920792), kC2_1 = f32(-1.0925484305920792),
                kC2_2 = f32(0.31539156525252005), kC2_3 = f32(-1.0925484305920792),
                kC2_4 = f32(0.5462742152960396);
constexpr float kC3_0 = f32(-0.5900435899266435), kC3_1 = f32(2.890611442640554),
                kC3_2 = f32(-0.4570457994644658), kC3_3 = f32(0.3731763325901154),
                kC3_4 = f32(-0.4570457994644658), kC3_5 = f32(1.445305721320277),
                kC3_6 = f32(-0.5900435899266435);

// torch.clamp_min, torch.clamp_max, torch.clamp, torch.minimum and
// torch.maximum on CUDA (and the min / max reductions): NaN propagates.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// common.py:_tile_index: clip(int32(v), 0, hi), truncating toward zero
__device__ __forceinline__ int tile_index(float v, int hi) {
  const int i = __float2int_rz(clamp(v, -1.0f, f32(hi + 1.0)));
  return min(max(i, 0), hi);
}

// Floats of one row's SH coefficients that degree kDeg reads (0 for
// kDeg -1: the caller gives the colours), and their odd stride in shared
// memory, so that each thread reads its own row without bank conflicts.
template <int kDeg>
__host__ __device__ constexpr int sh_row_floats() {
  return kDeg >= 0 ? (kDeg + 1) * (kDeg + 1) * 3 : 0;
}

template <int kDeg>
__host__ __device__ constexpr int sh_row_stride() { return sh_row_floats<kDeg>() | 1; }

// Copies the SH rows of the block's rows g0 .. g0 + kThreads - 1 (< n)
// into sh_s: each warp copies whole rows, consecutive lanes on consecutive
// floats. The caller synchronises the block before reading them.
template <int kDeg, int kThreads>
__device__ __forceinline__ void stage_sh(const float* __restrict__ shs, int sh_stride, int n,
                                         int g0, float* sh_s) {
  constexpr int kRow = sh_row_floats<kDeg>();
  constexpr int kPad = sh_row_stride<kDeg>();
  const int rows = min(kThreads, n - g0);
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    const float* src = shs + static_cast<size_t>(g0 + r) * sh_stride * 3;
    for (int j = lane; j < kRow; j += 32) sh_s[r * kPad + j] = __ldg(src + j);
  }
}

// The unit view direction of core/sh.py's callers: (p - campos) times
// rsqrt of its squared norm + 1e-20, the norm summed in the order of
// PyTorch's CUDA sum over a last dimension of 3, (a0 + a2) + a1.
__device__ __forceinline__ void view_dir(float px, float py, float pz,
                                         const float* __restrict__ campos, float& x, float& y,
                                         float& z) {
  const float dx = px - campos[0], dy = py - campos[1], dz = pz - campos[2];
  const float inv = rsqrtf((dx * dx + dz * dz) + dy * dy + f32(1e-20));
  x = dx * inv;
  y = dy * inv;
  z = dz * inv;
}

// core/sh.py:eval_sh, channel c of one row's coefficients sh (row-major
// [K][3]), then the + 0.5 and the clamp at 0 of both preprocesses.
template <int kDeg>
__device__ __forceinline__ float sh_color(const float* sh, int c, float x, float y, float z) {
  float r = kC0 * sh[c];
  if constexpr (kDeg > 0) {
    r = r - kC1 * y * sh[3 + c] + kC1 * z * sh[6 + c] - kC1 * x * sh[9 + c];
  }
  if constexpr (kDeg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    r = r + kC2_0 * xy * sh[12 + c] + kC2_1 * yz * sh[15 + c] +
        kC2_2 * (2.0f * zz - xx - yy) * sh[18 + c] + kC2_3 * xz * sh[21 + c] +
        kC2_4 * (xx - yy) * sh[24 + c];
    if constexpr (kDeg > 2) {
      r = r + kC3_0 * y * (3.0f * xx - yy) * sh[27 + c] + kC3_1 * xy * z * sh[30 + c] +
          kC3_2 * y * (4.0f * zz - xx - yy) * sh[33 + c] +
          kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy) * sh[36 + c] +
          kC3_4 * x * (4.0f * zz - xx - yy) * sh[39 + c] +
          kC3_5 * z * (xx - yy) * sh[42 + c] + kC3_6 * x * (xx - 3.0f * yy) * sh[45 + c];
    }
  }
  return clamp_min(r + 0.5f, 0.0f);
}

}  // namespace prep
