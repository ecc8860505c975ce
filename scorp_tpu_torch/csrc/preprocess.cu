// The fused preprocess: projection, EWA 2D covariance, cull, binning rect
// and SH colour of every gaussian in one launch, one thread per row.
//
// Replaces no TPU kernel: the JAX package's preprocess
// (scorp_tpu/ops/raster/common.py:preprocess) is elementwise code that XLA
// fuses. Its plain PyTorch version here,
// scorp_tpu_torch/ops/raster/common.py:preprocess_plain, dispatches ~545
// ATen ops at SH degree 3, each one pass over the rows, so the host's
// dispatch paces an eval frame and every intermediate goes through device
// memory. The wrapper: scorp_tpu_torch/ops/raster/fused_preprocess.py;
// rasterize takes it wherever autograd has nothing to record.
//
// Input per row g < n: xyz[g][3], opacity[g] (activated), either
// scales[g][3] (activated) and quats[g][4] (w x y z, unnormalised) or
// cov3d[g][6] (upper triangle), either shs[g][K][3] (sh_degree 0-3,
// K = sh_stride >= (sh_degree + 1)^2) or nothing (sh_degree -1: the
// caller's colours), deltas[g][2] (added to the NDC position) or null,
// alive[g] (bool) or null; the camera's viewmatrix[4][4]
// and projmatrix[4][4] (transposed, row-vector style), campos[3], tanfovx
// and tanfovy (0-d), all on the device. Output per row: xy[2], depth,
// conic[3], color[3] (not with sh_degree -1), radii (int32), rect[4] (int32
// binning tile rect, half-open, zero unless valid) and valid (bool).
//
// Numerics: the plain version's operations in its order, each constant
// rounded to f32 as PyTorch rounds a Python scalar (double, then float);
// built with -fmad=false, so no multiply-add is contracted and the outputs
// are bit-identical to the plain version's on the card. The clamps,
// torch.minimum and torch.clamp propagate NaN as PyTorch's CUDA ops do;
// float -> int32 truncates with NaN to 0, saturating, as PyTorch's
// conversion compiles; sqrtf and the divisions are IEEE, and rsqrtf and
// logf are the functions PyTorch's rsqrt and log call. The two row sums
// (the quaternion's squared norm, the view direction's) add in the order of
// PyTorch's CUDA sum over a last dimension of 4 and of 3, as measured on
// an H100 under PyTorch 2.11: two lanes each add every second element and a
// shuffle adds the lanes, (a0 + a2) + (a1 + a3) and (a0 + a2) + a1. The
// card test of every field against the plain version catches another order.
//
// What bounds it on an H100: bytes. At SH degree 3 with scales, quats and
// alive a row reads 237 B and writes 57 B: at 1.5M rows 442 MB, 0.13 ms at
// 3.35 TB/s. Its few hundred f32 operations a row are a tenth of that time
// at 67 TFLOP/s.
//
// Design: one thread per row, 128 rows a block. The SH coefficients (192 of
// a row's 237 B) are staged through shared memory: each warp copies whole
// rows of the block, consecutive lanes on consecutive floats, into rows
// padded to an odd stride, so that each thread then reads its own row
// without bank conflicts. The other inputs (12-16 B a row) are read per
// thread, neighbouring threads on neighbouring rows; the camera's 37 floats
// are reads that every thread of a warp makes at one address. Rows write
// xy as one 8-byte and rect as one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

using namespace prep;

constexpr int kThreads = 128;

// kDeg: the SH degree 0-3 of the colour, or -1 where the caller gives it.
template <int kDeg>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    const float* __restrict__ xyz, const float* __restrict__ opacity,
    const float* __restrict__ scales, const float* __restrict__ quats,
    const float* __restrict__ cov3d, const float* __restrict__ shs,
    const float* __restrict__ deltas, const unsigned char* __restrict__ alive,
    const float* __restrict__ V,
    const float* __restrict__ P, const float* __restrict__ campos,
    const float* __restrict__ tanfovx, const float* __restrict__ tanfovy, int n, int width,
    int height, int sh_stride, float scale_modifier, float2* __restrict__ xy_out,
    float* __restrict__ depth_out, float* __restrict__ conic_out,
    float* __restrict__ color_out, int* __restrict__ radii_out, int4* __restrict__ rect_out,
    unsigned char* __restrict__ valid_out) {
  constexpr int kPad = sh_row_stride<kDeg>();
  __shared__ float sh_s[kThreads * kPad];
  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + threadIdx.x;
  if constexpr (kDeg >= 0) {
    stage_sh<kDeg, kThreads>(shs, sh_stride, n, g0, sh_s);
    __syncthreads();
  }
  if (g >= n) return;

  const size_t g3 = static_cast<size_t>(g) * 3;
  const float px = xyz[g3], py = xyz[g3 + 1], pz = xyz[g3 + 2];
  // row-vector transforms, scalarized
  const float view_x = px * V[0] + py * V[4] + pz * V[8] + V[12];
  const float view_y = px * V[1] + py * V[5] + pz * V[9] + V[13];
  const float depth = px * V[2] + py * V[6] + pz * V[10] + V[14];
  const float clip_x = px * P[0] + py * P[4] + pz * P[8] + P[12];
  const float clip_y = px * P[1] + py * P[5] + pz * P[9] + P[13];
  const float clip_w = px * P[3] + py * P[7] + pz * P[11] + P[15];
  const float p_w = 1.0f / (clip_w + f32(1e-7));
  float ndc_x = clip_x * p_w;
  float ndc_y = clip_y * p_w;
  const bool in_front = depth > f32(0.2);
  if (deltas != nullptr) {
    ndc_x = ndc_x + deltas[2 * static_cast<size_t>(g)];
    ndc_y = ndc_y + deltas[2 * static_cast<size_t>(g) + 1];
  }
  // ndc2Pix: ((v + 1) * S - 1) * 0.5
  const float pix_x = (ndc_x + 1.0f) * f32(width * 0.5) - 0.5f;
  const float pix_y = (ndc_y + 1.0f) * f32(height * 0.5) - 0.5f;

  // --- 3D covariance (common.py:compute_cov3d) ---
  float s00, s01, s02, s11, s12, s22;
  if (cov3d != nullptr) {
    const size_t g6 = static_cast<size_t>(g) * 6;
    s00 = cov3d[g6];
    s01 = cov3d[g6 + 1];
    s02 = cov3d[g6 + 2];
    s11 = cov3d[g6 + 3];
    s12 = cov3d[g6 + 4];
    s22 = cov3d[g6 + 5];
  } else {
    const size_t g4 = static_cast<size_t>(g) * 4;
    const float q0 = quats[g4], q1 = quats[g4 + 1], q2 = quats[g4 + 2], q3 = quats[g4 + 3];
    // clamp INSIDE the sqrt (see core.quat.quat_to_rotmat)
    const float norm = sqrtf(clamp_min((q0 * q0 + q2 * q2) + (q1 * q1 + q3 * q3), f32(1e-24)));
    const float w = q0 / norm, x = q1 / norm, y = q2 / norm, z = q3 / norm;
    const float r00 = 1.0f - 2.0f * (y * y + z * z);
    const float r01 = 2.0f * (x * y - w * z);
    const float r02 = 2.0f * (x * z + w * y);
    const float r10 = 2.0f * (x * y + w * z);
    const float r11 = 1.0f - 2.0f * (x * x + z * z);
    const float r12 = 2.0f * (y * z - w * x);
    const float r20 = 2.0f * (x * z - w * y);
    const float r21 = 2.0f * (y * z + w * x);
    const float r22 = 1.0f - 2.0f * (x * x + y * y);
    const float sx = scales[g3] * scale_modifier;
    const float sy = scales[g3 + 1] * scale_modifier;
    const float sz = scales[g3 + 2] * scale_modifier;
    const float e0 = sx * sx, e1 = sy * sy, e2 = sz * sz;
    s00 = r00 * r00 * e0 + r01 * r01 * e1 + r02 * r02 * e2;
    s01 = r00 * r10 * e0 + r01 * r11 * e1 + r02 * r12 * e2;
    s02 = r00 * r20 * e0 + r01 * r21 * e1 + r02 * r22 * e2;
    s11 = r10 * r10 * e0 + r11 * r11 * e1 + r12 * r12 * e2;
    s12 = r10 * r20 * e0 + r11 * r21 * e1 + r12 * r22 * e2;
    s22 = r20 * r20 * e0 + r21 * r21 * e1 + r22 * r22 * e2;
  }

  // --- EWA 2D covariance ---
  const float tfx = *tanfovx, tfy = *tanfovy;
  // w / (2 tanfovx) with a 0-d tensor: PyTorch takes reciprocal(2 t) * w
  const float focal_x = (1.0f / (2.0f * tfx)) * static_cast<float>(width);
  const float focal_y = (1.0f / (2.0f * tfy)) * static_cast<float>(height);
  const float limx = f32(1.3) * tfx;
  const float limy = f32(1.3) * tfy;
  const float tz = in_front ? depth : 1.0f;  // safe divisor in culled lanes
  const float inv_z = 1.0f / tz;
  const float tx = clamp(view_x * inv_z, -limx, limx) * tz;
  const float ty = clamp(view_y * inv_z, -limy, limy) * tz;

  // M = J @ R_w2c; R_w2c rows are V's columns (V stores W2C transposed)
  const float j00 = focal_x * inv_z;
  const float j02 = -focal_x * tx * inv_z * inv_z;
  const float j11 = focal_y * inv_z;
  const float j12 = -focal_y * ty * inv_z * inv_z;
  const float m00 = j00 * V[0] + j02 * V[2];
  const float m01 = j00 * V[4] + j02 * V[6];
  const float m02 = j00 * V[8] + j02 * V[10];
  const float m10 = j11 * V[1] + j12 * V[2];
  const float m11 = j11 * V[5] + j12 * V[6];
  const float m12 = j11 * V[9] + j12 * V[10];
  // cov2 = M Σ Mᵀ
  const float t0x = m00 * s00 + m01 * s01 + m02 * s02;
  const float t0y = m00 * s01 + m01 * s11 + m02 * s12;
  const float t0z = m00 * s02 + m01 * s12 + m02 * s22;
  const float t1x = m10 * s00 + m11 * s01 + m12 * s02;
  const float t1y = m10 * s01 + m11 * s11 + m12 * s12;
  const float t1z = m10 * s02 + m11 * s12 + m12 * s22;
  const float c00 = t0x * m00 + t0y * m01 + t0z * m02 + f32(0.3);
  const float c01 = t1x * m00 + t1y * m01 + t1z * m02;
  const float c11 = t1x * m10 + t1y * m11 + t1z * m12 + f32(0.3);

  const float det = c00 * c11 - c01 * c01;
  const bool det_ok = det != 0.0f;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const size_t gc = static_cast<size_t>(g) * 3;
  conic_out[gc] = c11 * inv_det;
  conic_out[gc + 1] = -c01 * inv_det;
  conic_out[gc + 2] = c00 * inv_det;

  const float mid = 0.5f * (c00 + c11);
  const float disc = sqrtf(clamp_min(mid * mid - det, f32(0.1)));
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min(mid + disc, 0.0f)));
  const int radius = __float2int_rz(radius_f);

  // exact alpha >= 1/255 ellipse bbox, min'd with the circular-radius rect
  const float o = opacity[g];
  const float t2 = clamp_min(2.0f * logf(clamp_min(o, f32(1e-12)) * 255.0f), 0.0f);
  const bool keep = in_front && det_ok && t2 > 0.0f;
  const float rx = keep ? minimum(radius_f, sqrtf(t2 * clamp_min(c00, 0.0f))) : 0.0f;
  const float ry = keep ? minimum(radius_f, sqrtf(t2 * clamp_min(c11, 0.0f))) : 0.0f;
  const int tiles_x = (width + kTile - 1) / kTile, tiles_y = (height + kTile - 1) / kTile;
  // (v + TILE - 1) is ((v + 16) - 1) in the plain version's order
  const int x0 = tile_index((pix_x - rx) * kInvTile, tiles_x);
  const int y0 = tile_index((pix_y - ry) * kInvTile, tiles_y);
  const int x1 = tile_index((pix_x + rx + 16.0f - 1.0f) * kInvTile, tiles_x);
  const int y1 = tile_index((pix_y + ry + 16.0f - 1.0f) * kInvTile, tiles_y);
  const bool is_alive = alive == nullptr || alive[g] != 0;
  const bool valid = keep && x1 > x0 && y1 > y0 && (rx > 0.0f || ry > 0.0f) && is_alive;
  rect_out[g] = valid ? make_int4(x0, y0, x1, y1) : make_int4(0, 0, 0, 0);
  valid_out[g] = valid;

  // reported radii keep the reference's semantics (its rect is
  // radius-circular and ignores opacity)
  const int rx0 = tile_index((pix_x - radius_f) * kInvTile, tiles_x);
  const int ry0 = tile_index((pix_y - radius_f) * kInvTile, tiles_y);
  const int rx1 = tile_index((pix_x + radius_f + 16.0f - 1.0f) * kInvTile, tiles_x);
  const int ry1 = tile_index((pix_y + radius_f + 16.0f - 1.0f) * kInvTile, tiles_y);
  const bool valid_ref = in_front && det_ok && (rx1 - rx0) * (ry1 - ry0) > 0 && is_alive;
  radii_out[g] = valid_ref ? radius : 0;

  xy_out[g] = make_float2(pix_x, pix_y);
  depth_out[g] = depth;

  // --- colour: core/sh.py:eval_sh, then the clamp at 0 ---
  if constexpr (kDeg >= 0) {
    float x, y, z;
    view_dir(px, py, pz, campos, x, y, z);
    const float* sh = sh_s + threadIdx.x * kPad;
#pragma unroll
    for (int c = 0; c < 3; ++c) color_out[gc + c] = sh_color<kDeg>(sh, c, x, y, z);
  }
}

template <int kDeg>
cudaError_t launch(const void* xyz, const void* opacity, const void* scales, const void* quats,
                   const void* cov3d, const void* shs, const void* deltas,
                   const void* alive, const void* V,
                   const void* P, const void* campos, const void* tanfovx,
                   const void* tanfovy, int n, int width, int height, int sh_stride,
                   float scale_modifier, void* xy, void* depth, void* conic, void* color,
                   void* radii, void* rect, void* valid, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  preprocess_kernel<kDeg><<<grid, kThreads, 0, stream>>>(
      (const float*)xyz, (const float*)opacity, (const float*)scales, (const float*)quats,
      (const float*)cov3d, (const float*)shs, (const float*)deltas,
      (const unsigned char*)alive, (const float*)V,
      (const float*)P, (const float*)campos, (const float*)tanfovx, (const float*)tanfovy, n,
      width, height, sh_stride, scale_modifier, (float2*)xy, (float*)depth, (float*)conic,
      (float*)color, (int*)radii, (int4*)rect, (unsigned char*)valid);
  return cudaGetLastError();
}

}  // namespace

// sh_degree -1: no colour (color may be null). scales and quats may be
// null where cov3d is given, deltas and alive may be null. n > 0.
extern "C" int scorp_preprocess(const void* xyz, const void* opacity, const void* scales,
                                const void* quats, const void* cov3d, const void* shs,
                                const void* deltas, const void* alive,
                                const void* viewmatrix,
                                const void* projmatrix, const void* campos,
                                const void* tanfovx, const void* tanfovy, int n, int width,
                                int height, int sh_degree, int sh_stride,
                                float scale_modifier, void* xy, void* depth, void* conic,
                                void* color, void* radii, void* rect, void* valid,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define SCORP_PREPROCESS_LAUNCH(D)                                                          \
  launch<D>(xyz, opacity, scales, quats, cov3d, shs, deltas, alive, viewmatrix, projmatrix, \
            campos, tanfovx, tanfovy, n, width, height, sh_stride, scale_modifier, xy,     \
            depth, conic, color, radii, rect, valid, s)
  switch (sh_degree) {
    case -1: return (int)SCORP_PREPROCESS_LAUNCH(-1);
    case 0: return (int)SCORP_PREPROCESS_LAUNCH(0);
    case 1: return (int)SCORP_PREPROCESS_LAUNCH(1);
    case 2: return (int)SCORP_PREPROCESS_LAUNCH(2);
    case 3: return (int)SCORP_PREPROCESS_LAUNCH(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCORP_PREPROCESS_LAUNCH
}
