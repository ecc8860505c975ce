// The fused surfel preprocess: the 2DGS eval path's per-surfel work in one
// launch, one thread per row. It writes what the plain stages
// preprocess_surfel, surfel_table and surfel_cull_ellipses
// (scorp_tpu_torch/ops/raster/surfel.py) give the routing and K4: the
// [N, 21] stream table, K1's two [N, 6] cull ellipses, depth, rect, radii
// and valid. The homography M never leaves the thread: the table's
// adjugate rows and the float64 conic completion are made from it in
// registers.
//
// Replaces no TPU kernel: the JAX package's preprocess_surfel,
// surfel_table and surfel_cull_ellipses are elementwise code that XLA
// fuses. Their plain PyTorch versions dispatch ~517 ATen ops a frame at SH
// degree 3, each one pass over the rows, so the host's dispatch paces a
// 2DGS eval frame and every intermediate goes through device memory. The
// wrapper: scorp_tpu_torch/ops/raster/fused_surfel_preprocess.py;
// rasterize_surfel takes it wherever autograd has nothing to record.
//
// Input per row g < n: xyz[g][3], opacity[g] (activated), scales[g][2]
// (activated), quats[g][4] (w x y z, unnormalised), either shs[g][K][3]
// (sh_degree 0-3, K = sh_stride >= (sh_degree + 1)^2) or colors[g][3]
// (sh_degree -1), deltas[g][2] (added to the pixel position, times half
// the image size) or null, alive[g] (bool) or null; the camera's
// viewmatrix[4][4] (transposed, row-vector style), cam_a[3][3] and
// cam_b[3] (the world -> (xw, yw, w) map K R_w2c and K t_w2c, made by the
// wrapper with the plain version's own ops) and campos[3], on the device.
// Output per row: table[21] (adj(M) normalised 0-8, zrow 9-11, xy 12-13,
// colour 14-16, camera-facing view normal 17-19, log2 opacity 20), ell[6]
// (the UV disc's conic) and circ[6] (the low-pass circle), each (cx, cy,
// A, B, C, threshold), depth, radii (int32), rect[4] (int32 binning tile
// rect, half-open, zero unless valid) and valid (bool).
//
// Numerics: the plain stages' operations in their order, each constant
// rounded to f32 as PyTorch rounds a Python scalar; built with -fmad=false,
// so nothing is contracted that PyTorch does not contract. Where a plain
// op is one kernel that does contract, the kernel repeats it with explicit
// __fmaf_rn, as measured on an H100 under PyTorch 2.11 with cuBLAS 12:
// - [N, 3] @ [3, 3] (at::mm, cuBLAS sgemm: M's columns, the view normal
//   and position) is the chain fma(a2, b2, fma(a1, b1, fma(a0, b0, 0)))
//   (dot3) at every N measured (160 to 1,503,232 rows);
// - [N, 3] @ [3] (at::mv, cuBLAS sgemv: zrow and depth) adds two threads'
//   fused partial sums, and which terms each holds depends on N: k = 0, 1
//   | 2 up to at least 250,000 rows, k = 0, 2 | 1 at 1,503,232 (gemv3).
//   The wrapper finds the split cuBLAS takes at the call's N once, by a
//   probe row whose two sums differ (fused_surfel_preprocess.zrow_order),
//   and passes it as zrow_order;
// - torch.linalg.cross (one elementwise kernel) is a1 b2 - a2 b1 as
//   fma(a1, b2, -(a2 b1)) (cross_term). In float64, on f32 operands, the
//   products are exact, so the cull's cross products need no such care.
// The row sums over 3 and 4 elements follow PyTorch's CUDA order as in
// preprocess.cu. The conic completion is float64 from the adjugate to the
// rounding at the end, as in the plain version (surfel_cull_ellipses says
// why float32 is not enough). The card test of every field against the
// plain stages catches another order.
//
// What bounds it on an H100: bytes. At SH degree 3 with alive a row reads
// 233 B (xyz 12, opacity 4, scales 8, quats 16, SH 192, alive 1) and
// writes 157 B (table 84, ellipses 48, rect 16, radii 4, depth 4, valid
// 1): at 1.5M rows 586 MB, 0.175 ms at 3.35 TB/s. Its ~300 f32 and ~100
// f64 operations a row (10 f64 divisions) take a few microseconds at the
// card's 67 TFLOP/s f32 and 34 TFLOP/s f64.
//
// Design: one thread per row, 128 rows a block. The SH rows are staged
// through shared memory at an odd stride, as in preprocess.cu. Each thread
// writes its table row into shared memory (stride 21, odd: no bank
// conflicts), and the block then stores its 128 rows, one contiguous
// 10,752-byte run, as 16-byte stores, neighbouring threads on neighbouring
// addresses. The ellipses go out as 8-byte stores and rect as one 16-byte
// store a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "preprocess_common.cuh"

namespace {

using namespace prep;

constexpr int kThreads = 128;
constexpr int kCols = 21;  // stream table columns (surfel.py:SURFEL_COLS)

// one output element of an [N, 3] @ [3, k] cuBLAS product: sum_j a_j b_j
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmaf_rn(a0, b0, 0.0f)));
}

// one element of an [N, 3] @ [3] cuBLAS sgemv: two threads' partial sums,
// k = 0, 1 | 2 (order 0) or k = 0, 2 | 1 (order 1), each a fused chain
__device__ __forceinline__ float gemv3(float a0, float a1, float a2, float b0, float b1,
                                       float b2, int order) {
  const float p0 = __fmaf_rn(a0, b0, 0.0f);
  return order == 0 ? __fmaf_rn(a1, b1, p0) + __fmaf_rn(a2, b2, 0.0f)
                    : __fmaf_rn(a2, b2, p0) + __fmaf_rn(a1, b1, 0.0f);
}

// one component of torch.linalg.cross on CUDA: a * b - c * d
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

__device__ __forceinline__ void cross64(const float* a, const float* b, double* out) {
  out[0] = double(a[1]) * double(b[2]) - double(a[2]) * double(b[1]);
  out[1] = double(a[2]) * double(b[0]) - double(a[0]) * double(b[2]);
  out[2] = double(a[0]) * double(b[1]) - double(a[1]) * double(b[0]);
}

__device__ __forceinline__ double maximum64(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : fmax(a, b));
}

// kDeg: the SH degree 0-3 of the colour, or -1 where the caller gives it.
template <int kDeg>
__global__ void __launch_bounds__(kThreads) surfel_preprocess_kernel(
    const float* __restrict__ xyz, const float* __restrict__ opacity,
    const float* __restrict__ scales, const float* __restrict__ quats,
    const float* __restrict__ shs, const float* __restrict__ colors,
    const float* __restrict__ deltas, const unsigned char* __restrict__ alive,
    const float* __restrict__ V, const float* __restrict__ cam_a,
    const float* __restrict__ cam_b, const float* __restrict__ campos, int n, int width,
    int height, int sh_stride, int zrow_order, float scale_modifier, float* __restrict__ table,
    float2* __restrict__ ell_out, float2* __restrict__ circ_out, float* __restrict__ depth_out,
    int* __restrict__ radii_out, int4* __restrict__ rect_out,
    unsigned char* __restrict__ valid_out) {
  constexpr int kPad = sh_row_stride<kDeg>();
  __shared__ float sh_s[kThreads * kPad];
  __shared__ __align__(16) float tab_s[kThreads * kCols];
  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + threadIdx.x;
  if constexpr (kDeg >= 0) {
    stage_sh<kDeg, kThreads>(shs, sh_stride, n, g0, sh_s);
    __syncthreads();
  }

  if (g < n) {
    float* row = tab_s + threadIdx.x * kCols;
    const size_t g2 = static_cast<size_t>(g) * 2, g3 = static_cast<size_t>(g) * 3;
    const float px = xyz[g3], py = xyz[g3 + 1], pz = xyz[g3 + 2];

    // --- the surfel's frame: core/quat.py:quat_to_rotmat, columns t_u t_v t_n ---
    const size_t g4 = static_cast<size_t>(g) * 4;
    const float q0 = quats[g4], q1 = quats[g4 + 1], q2 = quats[g4 + 2], q3 = quats[g4 + 3];
    // clamp INSIDE the sqrt; the sum over 4 in PyTorch's order
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
    const float su = scales[g2] * scale_modifier;
    const float sv = scales[g2 + 1] * scale_modifier;
    const float u0 = r00 * su, u1 = r10 * su, u2 = r20 * su;  // axis_u (world)
    const float v0 = r01 * sv, v1 = r11 * sv, v2 = r21 * sv;  // axis_v

    // --- M = [axis_u A^T, axis_v A^T, xyz A^T + b] (columns), zrow ---
    float m0[3], m1[3], m2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a0 = cam_a[3 * i], a1 = cam_a[3 * i + 1], a2 = cam_a[3 * i + 2];
      m0[i] = dot3(u0, u1, u2, a0, a1, a2);
      m1[i] = dot3(v0, v1, v2, a0, a1, a2);
      m2[i] = dot3(px, py, pz, a0, a1, a2) + cam_b[i];
    }
    // r_w2c.T[:, 2] is V's column 2; t_w2c[2] is V[14]
    const float zu = gemv3(u0, u1, u2, V[2], V[6], V[10], zrow_order);
    const float zv = gemv3(v0, v1, v2, V[2], V[6], V[10], zrow_order);
    const float zc = gemv3(px, py, pz, V[2], V[6], V[10], zrow_order) + V[14];

    const bool in_front = zc > f32(0.2);
    const float w_center = fabsf(m2[2]) > f32(1e-8) ? m2[2] : f32(1e-8);
    float pix_x = m2[0] / w_center;
    float pix_y = m2[1] / w_center;
    if (deltas != nullptr) {
      pix_x = pix_x + deltas[g2] * f32(width * 0.5);
      pix_y = pix_y + deltas[g2 + 1] * f32(height * 0.5);
    }

    // --- conservative screen bbox: the ±c_uv corners projected, unioned
    // with the low-pass disc around the centre ---
    const float o = opacity[g];
    const float t2 = clamp_min(2.0f * logf(clamp_min(o, f32(1e-12)) * 255.0f), 0.0f);
    const float c_uv = clamp_max(sqrtf(t2), 3.0f);
    float cmin_x = 0.0f, cmin_y = 0.0f, cmax_x = 0.0f, cmax_y = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sx = k < 2 ? -1.0f : 1.0f, sy = (k & 1) ? 1.0f : -1.0f;
      const float hx = m2[0] + c_uv * (sx * m0[0] + sy * m1[0]);
      const float hy = m2[1] + c_uv * (sx * m0[1] + sy * m1[1]);
      const float hz = m2[2] + c_uv * (sx * m0[2] + sy * m1[2]);
      const float wc = clamp_min(hz, f32(1e-2));  // clamp behind-camera corners
      const float cx = hx / wc, cy = hy / wc;
      cmin_x = k ? minimum(cmin_x, cx) : cx;
      cmin_y = k ? minimum(cmin_y, cy) : cy;
      cmax_x = k ? maximum(cmax_x, cx) : cx;
      cmax_y = k ? maximum(cmax_y, cy) : cy;
    }
    const float r_lp = sqrtf(t2 * 0.5f);  // t2 / FILTER_INV_SQUARE
    const float lo_x = minimum(cmin_x, pix_x - r_lp), lo_y = minimum(cmin_y, pix_y - r_lp);
    const float hi_x = maximum(cmax_x, pix_x + r_lp), hi_y = maximum(cmax_y, pix_y + r_lp);
    const int tiles_x = (width + kTile - 1) / kTile, tiles_y = (height + kTile - 1) / kTile;
    // (v + TILE - 1) is ((v + 16) - 1) in the plain version's order
    const int x0 = tile_index(lo_x * kInvTile, tiles_x);
    const int y0 = tile_index(lo_y * kInvTile, tiles_y);
    const int x1 = tile_index((hi_x + 16.0f - 1.0f) * kInvTile, tiles_x);
    const int y1 = tile_index((hi_y + 16.0f - 1.0f) * kInvTile, tiles_y);
    const bool is_alive = alive == nullptr || alive[g] != 0;
    const bool valid = in_front && t2 > 0.0f && x1 > x0 && y1 > y0 && is_alive;
    rect_out[g] = valid ? make_int4(x0, y0, x1, y1) : make_int4(0, 0, 0, 0);
    valid_out[g] = valid;
    const float half_extent =
        maximum(maximum(hi_x - pix_x, pix_x - lo_x), maximum(hi_y - pix_y, pix_y - lo_y));
    radii_out[g] = valid ? __float2int_rz(ceilf(half_extent)) : 0;
    depth_out[g] = zc;

    // --- view-space normal, sign-flipped toward the camera ---
    float nv[3], pv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      nv[j] = dot3(r02, r12, r22, V[j], V[4 + j], V[8 + j]);
      pv[j] = dot3(px, py, pz, V[j], V[4 + j], V[8 + j]) + V[12 + j];
    }
    const float facing = -((pv[0] * nv[0] + pv[2] * nv[2]) + pv[1] * nv[1]);
    const float flip = facing > 0.0f ? 1.0f : -1.0f;

    // --- the table row: adj(M) / max |adj|, zrow, xy, colour, normal, log2 opacity ---
    float adj[9];
    cross(m1, m2, adj);
    cross(m2, m0, adj + 3);
    cross(m0, m1, adj + 6);
    float amax = fabsf(adj[0]);
#pragma unroll
    for (int j = 1; j < 9; ++j) amax = maximum(amax, fabsf(adj[j]));
    const float anrm = clamp_min(amax, f32(1e-30));
#pragma unroll
    for (int j = 0; j < 9; ++j) row[j] = adj[j] / anrm;
    row[9] = zu;
    row[10] = zv;
    row[11] = zc;
    row[12] = pix_x;
    row[13] = pix_y;
    if constexpr (kDeg >= 0) {
      float dx, dy, dz;
      view_dir(px, py, pz, campos, dx, dy, dz);
      const float* sh = sh_s + threadIdx.x * kPad;
#pragma unroll
      for (int c = 0; c < 3; ++c) row[14 + c] = sh_color<kDeg>(sh, c, dx, dy, dz);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) row[14 + c] = colors[g3 + c];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) row[17 + j] = nv[j] * flip;
    row[20] = log2f(clamp_min(o, f32(1e-30)));

    // --- K1's ellipses (surfel_cull_ellipses), the conic completed in float64 ---
    double a[9];
    cross64(m1, m2, a);
    cross64(m2, m0, a + 3);
    cross64(m0, m1, a + 6);
    double dmax = fabs(a[0]);
#pragma unroll
    for (int j = 1; j < 9; ++j) dmax = maximum64(dmax, fabs(a[j]));
    const double dnrm = isnan(dmax) ? dmax : fmax(dmax, 1e-30);
#pragma unroll
    for (int j = 0; j < 9; ++j) a[j] = a[j] / dnrm;
    const double t2d = t2;
    // q(i, j) = a1_i a1_j + a2_i a2_j - t2 a3_i a3_j, rows a1 = a[0:3] ...
    auto q = [&](int i, int j) {
      return (a[i] * a[j] + a[3 + i] * a[3 + j]) - t2d * a[6 + i] * a[6 + j];
    };
    const double qa = q(0, 0), qb = q(0, 1), qc = q(1, 1);
    const double q0d = q(0, 2), q1d = q(1, 2), cq = q(2, 2);
    const double det2 = qa * qc - qb * qb;
    const bool pd = qa > 0.0 && qc > 0.0 && det2 > 0.0;
    const double inv_det = 1.0 / (pd ? det2 : 1.0);
    const double ex = (qb * q1d - qc * q0d) * inv_det;
    const double ey = (qb * q0d - qa * q1d) * inv_det;
    const bool ok = pd && fabs(ex) < 1e6 && fabs(ey) < 1e6;
    const double rho = -((cq + q0d * ex) + q1d * ey);
    ell_out[3 * static_cast<size_t>(g)] =
        make_float2(ok ? float(ex) : 0.0f, ok ? float(ey) : 0.0f);
    ell_out[3 * static_cast<size_t>(g) + 1] =
        make_float2(ok ? float(qa) : 1.0f, ok ? float(qb) : 0.0f);
    ell_out[3 * static_cast<size_t>(g) + 2] =
        make_float2(ok ? float(qc) : 1.0f, ok ? float(rho) : float(1e30));
    circ_out[3 * static_cast<size_t>(g)] = make_float2(pix_x, pix_y);
    circ_out[3 * static_cast<size_t>(g) + 1] = make_float2(2.0f, 0.0f);
    circ_out[3 * static_cast<size_t>(g) + 2] = make_float2(2.0f, t2);
  }

  // the block's table rows, one contiguous run, in 16-byte stores
  __syncthreads();
  const int rows = min(kThreads, n - g0);
  float* dst = table + static_cast<size_t>(g0) * kCols;
  if (rows == kThreads) {
    const float4* src4 = reinterpret_cast<const float4*>(tab_s);
    float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = threadIdx.x; i < kThreads * kCols / 4; i += kThreads) dst4[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) dst[i] = tab_s[i];
  }
}

template <int kDeg>
cudaError_t launch(const void* xyz, const void* opacity, const void* scales, const void* quats,
                   const void* shs, const void* colors, const void* deltas, const void* alive,
                   const void* V, const void* cam_a, const void* cam_b, const void* campos,
                   int n, int width, int height, int sh_stride, int zrow_order,
                   float scale_modifier, void* table, void* ell, void* circ, void* depth,
                   void* radii, void* rect, void* valid, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  surfel_preprocess_kernel<kDeg><<<grid, kThreads, 0, stream>>>(
      (const float*)xyz, (const float*)opacity, (const float*)scales, (const float*)quats,
      (const float*)shs, (const float*)colors, (const float*)deltas,
      (const unsigned char*)alive, (const float*)V, (const float*)cam_a, (const float*)cam_b,
      (const float*)campos, n, width, height, sh_stride, zrow_order, scale_modifier,
      (float*)table,
      (float2*)ell, (float2*)circ, (float*)depth, (int*)radii, (int4*)rect,
      (unsigned char*)valid);
  return cudaGetLastError();
}

}  // namespace

// sh_degree -1: the colours are given (shs may be null); 0-3: shs is read
// (colors may be null). deltas and alive may be null. zrow_order 0 or 1
// (gemv3). n > 0; table 16-byte aligned, ell and circ 8-byte aligned.
extern "C" int scorp_surfel_preprocess(const void* xyz, const void* opacity, const void* scales,
                                       const void* quats, const void* shs, const void* colors,
                                       const void* deltas, const void* alive,
                                       const void* viewmatrix, const void* cam_a,
                                       const void* cam_b, const void* campos, int n, int width,
                                       int height, int sh_degree, int sh_stride, int zrow_order,
                                       float scale_modifier, void* table, void* ell, void* circ,
                                       void* depth, void* radii, void* rect, void* valid,
                                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define SCORP_SURFEL_PREPROCESS_LAUNCH(D)                                                     \
  launch<D>(xyz, opacity, scales, quats, shs, colors, deltas, alive, viewmatrix, cam_a, cam_b, \
            campos, n, width, height, sh_stride, zrow_order, scale_modifier, table, ell, circ, \
            depth, radii, rect, valid, s)
  if (zrow_order != 0 && zrow_order != 1) return (int)cudaErrorInvalidValue;
  switch (sh_degree) {
    case -1: return (int)SCORP_SURFEL_PREPROCESS_LAUNCH(-1);
    case 0: return (int)SCORP_SURFEL_PREPROCESS_LAUNCH(0);
    case 1: return (int)SCORP_SURFEL_PREPROCESS_LAUNCH(1);
    case 2: return (int)SCORP_SURFEL_PREPROCESS_LAUNCH(2);
    case 3: return (int)SCORP_SURFEL_PREPROCESS_LAUNCH(3);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCORP_SURFEL_PREPROCESS_LAUNCH
}
