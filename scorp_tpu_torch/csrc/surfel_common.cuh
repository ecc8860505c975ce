// Per (pixel, key) surfel geometry shared by kernels K4/K5
// (surfel_composite.cu) and K6 (surfel_backward.cu), so that the forward
// and the backward compositor evaluate alpha and z by one expression and
// agree on the 1/255 and z >= 0.2 tests bit for bit. The same expression,
// op for op, is scorp_tpu_torch/ops/raster/surfel_composite.py:surfel_hit;
// every source is built with -fmad=false, so no multiply-add contraction
// changes its rounding.
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

struct Hit {
  float s_z, sz, u_raw, v_raw, u, v, dx, dy, alpha_u, alpha, z;
  bool use3d;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ Hit hit(const float* __restrict__ key, float px, float py) {
  Hit h;
  const float sx = key[0] * px + key[1] * py + key[2];
  const float sy = key[3] * px + key[4] * py + key[5];
  h.s_z = key[6] * px + key[7] * py + key[8];
  h.sz = fabsf(h.s_z) > 1e-9f ? h.s_z : 1e-9f;
  h.u_raw = sx / h.sz;
  h.v_raw = sy / h.sz;
  h.u = clampf(h.u_raw, -1e3f, 1e3f);
  h.v = clampf(h.v_raw, -1e3f, 1e3f);
  const float rho3d = h.u * h.u + h.v * h.v;
  h.dx = key[12] - px;
  h.dy = key[13] - py;
  const float rho2d = kFilterInvSquare * (h.dx * h.dx + h.dy * h.dy);
  h.use3d = rho3d <= rho2d;
  const float rho = fminf(rho3d, rho2d);
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
