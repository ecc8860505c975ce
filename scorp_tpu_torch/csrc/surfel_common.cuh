// Per (pixel, key) surfel geometry shared by kernels K4/K5
// (surfel_composite.cu) and K6 (surfel_backward.cu), so that the forward
// and the backward compositor evaluate alpha and z by one expression and
// agree on the 1/255 and z >= 0.2 tests bit for bit. The same expression,
// op for op, is scorp_tpu_torch/ops/raster/surfel_composite.py:surfel_hit;
// every source is built with -fmad=false, so no multiply-add contraction
// changes its rounding.
//
// The expression is cut in two: geo() (the three rows of s = adj (px, py, 1)
// and the low-pass distance, no division) and hit() (the divisions, the u/v
// clip, the rho min, exp2 and z). Before them come two skips, each sound by
// construction (it rejects only what hit() would reject), which the three
// kernels share:
// - warp_mask(), evaluated once per key and batch by one thread: which of
//   the tile's 8 warps (2 pixel rows each) the key's footprint can reach;
//   a warp whose bit is clear skips the key for one shared-memory byte;
// - may_hit(), per (pixel, key) between geo() and hit(): a division-free
//   test; a warp in which no lane passes it skips hit().
// On the H100 the compositors are bound by the instruction rate, and about two
// thirds of the walked (warp, key) slots have no lane at alpha >= 1/255 (a
// key admitted to a 16x16 tile often misses the 2 pixel rows of a warp).
//
// Stream row of one key (21 f32): adj(M) 0-8 (rows a1 a2 a3, s = adj
// (px, py, 1)), zrow 9-11 (view z = u zu + v zv + zc), centre xy 12-13,
// color 14-16, view normal 17-19, log2 opacity 20.

#pragma once

#include <cuda_runtime.h>

namespace surfel {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kCols = 21;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kNear = 0.2f;
constexpr float kFilterInvSquare = 2.0f;
constexpr float kNC = (float)(-0.5 * 1.4426950408889634);          // -0.5 log2(e)
constexpr float kFF = (float)(100.0 / (100.0 - 0.2));               // FAR / (FAR - NEAR)
constexpr float kFFN = (float)(100.0 / (100.0 - 0.2) * 0.2);        // FF NEAR
constexpr float kLn2 = 0.6931471805599453f;
// may_hit's radius: alpha_u = opacity e^(-rho/2) >= 1/255 iff
// rho <= 2 ln2 (lopa + log2 255); the margin is over a hundred times the
// rounding of either side (exp2f's, the divisions', r's own) at the largest
// radius, 11.1 for opacity 1
constexpr float kLog2_255 = 7.994353436858858f;
constexpr float kTwoLn2 = 1.3862943611198906f;
constexpr float kRhoMargin = 1e-3f;

struct Geo {
  float sx, sy, s_z, sz, dx, dy, rho2d;
};

struct Hit {
  float u_raw, v_raw, u, v, alpha_u, alpha, z;
  bool use3d;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float radius(const float* __restrict__ key) {
  return (key[20] + kLog2_255) * kTwoLn2 + kRhoMargin;
}

__device__ __forceinline__ float min_square(float lo, float hi) {
  return lo > 0.0f ? lo * lo : (hi < 0.0f ? hi * hi : 0.0f);
}

// Bit w of the result is clear only if may_hit() is false at every pixel
// of warp w of the tile at (x0, y0), the pixels x0..x0+15 of rows y0+2w and
// y0+2w+1. Interval bounds of may_hit's f32 expressions over the warp's
// rectangle: each row of s = adj (px, py, 1) is affine, so its range is
// its centre value +- its slope times the half-extent, widened by 2^-18 of
// the sum of its terms' magnitudes over the tile (s0, s1, s2: over 8 times
// the f32 rounding of the row at any pixel and of these bounds
// themselves); then a lower bound of sx^2 + sy^2 and of rho2d and an upper
// bound of r sz^2 (sz^2 >= 1e-18 after the clamp), compared with 2^-18 of
// relative slack for the squares, sums and products. A NaN, an infinity or
// a term above 1e18 (where the squares could overflow) leaves every bit
// set; bounds under 1e-30 count as 0, where the squares may underflow.
__device__ __forceinline__ unsigned warp_mask(const float* __restrict__ key, int x0, int y0) {
  constexpr float kSlack = 1.0f / (1 << 18);
  constexpr unsigned kAll = (1u << (kPix / 32)) - 1;
  const float fx0 = (float)x0, xm = fx0 + 7.5f, xmax = fx0 + 15.0f;
  const float ymax_tile = (float)y0 + 15.0f;
  const float s0 = fabsf(key[0]) * xmax + fabsf(key[1]) * ymax_tile + fabsf(key[2]);
  const float s1 = fabsf(key[3]) * xmax + fabsf(key[4]) * ymax_tile + fabsf(key[5]);
  const float s2 = fabsf(key[6]) * xmax + fabsf(key[7]) * ymax_tile + fabsf(key[8]);
  const float cx = key[12], cy = key[13];
  if (!(s0 <= 1e18f && s1 <= 1e18f && s2 <= 1e18f && fabsf(cx) <= 1e18f && fabsf(cy) <= 1e18f)) {
    return kAll;  // also for a NaN, which fails every comparison
  }
  const float r = radius(key);
  const float ddx = fmaxf(0.0f, fmaxf(fx0 - cx, cx - xmax));
  unsigned mask = 0;
#pragma unroll 1
  for (int w = 0; w < kPix / 32; ++w) {
    const float ya = (float)(y0 + 2 * w), ym = ya + 0.5f;
    const float mx = key[0] * xm + key[1] * ym + key[2];
    const float hx = fabsf(key[0]) * 7.5f + fabsf(key[1]) * 0.5f + kSlack * s0;
    const float my = key[3] * xm + key[4] * ym + key[5];
    const float hy = fabsf(key[3]) * 7.5f + fabsf(key[4]) * 0.5f + kSlack * s1;
    const float mz = key[6] * xm + key[7] * ym + key[8];
    const float hz = fabsf(key[6]) * 7.5f + fabsf(key[7]) * 0.5f + kSlack * s2;
    float lhs = min_square(mx - hx, mx + hx) + min_square(my - hy, my + hy);
    if (lhs < 1e-30f) lhs = 0.0f;
    const float zlo = mz - hz, zhi = mz + hz;
    const float sz2 = fmaxf(fmaxf(zlo * zlo, zhi * zhi), 1e-18f);
    const bool far3 = lhs * (1.0f - kSlack) > r * sz2 * (1.0f + kSlack);
    const float ddy = fmaxf(0.0f, fmaxf(ya - cy, cy - (ya + 1.0f)));
    float rho2 = kFilterInvSquare * (ddx * ddx + ddy * ddy);
    if (rho2 < 1e-30f) rho2 = 0.0f;
    const bool far2 = rho2 * (1.0f - kSlack) > r;
    if (!(far3 && far2)) mask |= 1u << w;
  }
  return mask;
}

__device__ __forceinline__ Geo geo(const float* __restrict__ key, float px, float py) {
  Geo g;
  g.sx = key[0] * px + key[1] * py + key[2];
  g.sy = key[3] * px + key[4] * py + key[5];
  g.s_z = key[6] * px + key[7] * py + key[8];
  g.sz = fabsf(g.s_z) > 1e-9f ? g.s_z : 1e-9f;
  g.dx = key[12] - px;
  g.dy = key[13] - py;
  g.rho2d = kFilterInvSquare * (g.dx * g.dx + g.dy * g.dy);
  return g;
}

// False only if hit() gives alpha < 1/255: rho = min(rho3d, rho2d) can
// reach the radius r only through rho2d <= r or, without dividing,
// sx^2 + sy^2 <= r sz^2 (a clipped |u| or |v| of 1e3 makes rho3d >= 1e6,
// above any r for opacity <= 1, so the unclipped ratio decides). Written
// as !(a > b) so that a NaN passes and hit() decides.
__device__ __forceinline__ bool may_hit(const float* __restrict__ key, const Geo& g) {
  const float r = radius(key);
  return !(g.rho2d > r) || !(g.sx * g.sx + g.sy * g.sy > r * (g.sz * g.sz));
}

__device__ __forceinline__ Hit hit(const float* __restrict__ key, const Geo& g) {
  Hit h;
  h.u_raw = g.sx / g.sz;
  h.v_raw = g.sy / g.sz;
  h.u = clampf(h.u_raw, -1e3f, 1e3f);
  h.v = clampf(h.v_raw, -1e3f, 1e3f);
  const float rho3d = h.u * h.u + h.v * h.v;
  h.use3d = rho3d <= g.rho2d;
  const float rho = fminf(rho3d, g.rho2d);
  h.alpha_u = exp2f(kNC * rho + key[20]);
  h.alpha = fminf(kAlphaMax, h.alpha_u);
  h.z = h.use3d ? h.u * key[9] + h.v * key[10] + key[11] : key[11];
  return h;
}

// m = FF - FF NEAR / max(z, 1e-6): the distortion's NDC-mapped depth
__device__ __forceinline__ float distortion_m(float z) {
  return kFF - kFFN / fmaxf(z, 1e-6f);
}

}  // namespace surfel
