// Per (pixel, key) 3DGS alpha shared by kernels K2 (composite.cu) and K3
// (backward.cu), so that the forward and the backward compositor evaluate
// alpha by one expression and agree on the 1/255 test bit for bit. The same
// expression, op for op, is composite.py:composite_plain's and
// backward.py:composite_backward_plain's; every source is built with
// -fmad=false, so no multiply-add contraction changes its rounding.
//
// Before the alpha, a warp may skip a key by its bit of warp_mask(): an
// interval bound of alpha over each warp's 16x2 pixels, clear only where
// the exact test fails at every one of them (a key K1 admits to a 16x16
// tile often misses a warp's 2 pixel rows). Each kernel evaluates it once
// per key and batch, one thread per key, while staging the batch.
// It rejects only what the exact test rejects, so the included keys and
// every output stay those of the unskipped walk.
//
// Stream row of one key (10 f32): centre xy 0-1, the conic's Cholesky rows
// scaled by sqrt(log2 e) l11 l21 l22 2-4 (u = l11 dx + l21 dy, v = l22 dy),
// rgb 5-7, view depth z 8, log2 opacity 9.

#pragma once

#include <cuda_runtime.h>

namespace gauss {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kRows = 10;  // floats per stream row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kLn2 = 0.6931471805599453f;
// warp_mask's radius: alpha_u = 2^(lopa - q/2) >= 1/255 iff
// q = u^2 + v^2 <= 2 (lopa + log2 255); the margin in q is over a hundred
// times the rounding of exp2f and of power + lopa near the threshold
constexpr float kLog2_255 = 7.994353436858858f;
constexpr float kQMargin = 1e-3f;

struct Geo {
  float x, y, l11, l21, l22, lopa;
};

struct Alpha {
  float dx, dy, u, v, alpha_u, alpha;
};

// the geometry of a stream row in device memory
__device__ __forceinline__ Geo geo_of(const float* __restrict__ row) {
  return Geo{row[0], row[1], row[2], row[3], row[4], row[9]};
}

// alpha = min(0.99, 2^(lopa - (u^2 + v^2) / 2)), the gradient's alpha_u
// before the clamp, and the offsets it was computed from
__device__ __forceinline__ Alpha alpha_of(const Geo& k, float px, float py) {
  Alpha a;
  a.dx = k.x - px;
  a.dy = k.y - py;
  a.u = k.l11 * a.dx + k.l21 * a.dy;
  a.v = k.l22 * a.dy;
  const float power = -0.5f * (a.u * a.u + a.v * a.v);
  a.alpha_u = exp2f(power + k.lopa);
  a.alpha = fminf(kAlphaMax, a.alpha_u);
  return a;
}

__device__ __forceinline__ float min_square(float lo, float hi) {
  return lo > 0.0f ? lo * lo : (hi < 0.0f ? hi * hi : 0.0f);
}

// Bit w of the result is clear only if alpha_of() gives alpha < 1/255 at
// every pixel of warp w of the tile at (x0, y0), the pixels x0..x0+15 of
// rows y0+2w and y0+2w+1. u and v are affine in the pixel, so over the
// warp's rectangle each lies within its centre value +- its slope times the
// half-extent, widened by 2^-18 of the sum of its terms' magnitudes there
// (over 8 times the f32 rounding of u and v at any pixel and of these
// bounds themselves); min_square(u) + min_square(v) is then a lower bound
// of u^2 + v^2, compared with the radius with 2^-18 of relative slack for
// the squares and the sum. A NaN, an infinity or a term above 1e18 (where
// the squares could overflow) sets the bit; a bound under 1e-30 counts as
// 0, where the squares may underflow. A key with lopa + log2 255 below
// -kQMargin / 2 clears every bit.
__device__ __forceinline__ unsigned warp_mask(const Geo& k, int x0, int y0) {
  constexpr float kSlack = 1.0f / (1 << 18);
  constexpr unsigned kAll = (1u << kWarps) - 1;
  if (!(fabsf(k.lopa) <= 1e18f)) return kAll;  // also for a NaN
  const float r = (k.lopa + kLog2_255) * 2.0f + kQMargin;
  const float a11 = fabsf(k.l11), a21 = fabsf(k.l21), a22 = fabsf(k.l22);
  const float dxm = k.x - ((float)x0 + 7.5f);
  const float adx = fabsf(dxm) + 7.5f;
  unsigned mask = 0;
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    const float dym = k.y - ((float)(y0 + 2 * w) + 0.5f);
    const float ady = fabsf(dym) + 0.5f;
    const float su = a11 * adx + a21 * ady;
    const float sv = a22 * ady;
    if (!(su <= 1e18f && sv <= 1e18f)) {
      mask |= 1u << w;
      continue;
    }
    const float um = k.l11 * dxm + k.l21 * dym;
    const float hu = a11 * 7.5f + a21 * 0.5f + kSlack * su;
    const float vm = k.l22 * dym;
    const float hv = a22 * 0.5f + kSlack * sv;
    float q = min_square(um - hu, um + hu) + min_square(vm - hv, vm + hv);
    if (q < 1e-30f) q = 0.0f;
    if (!(q * (1.0f - kSlack) > r * (1.0f + kSlack))) mask |= 1u << w;
  }
  return mask;
}

}  // namespace gauss
