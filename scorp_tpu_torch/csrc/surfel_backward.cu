// Kernel K6: the surfel backward compositor, K5's reverse walk per tile.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_surfel_train.py:443
// (_surfel_bwd_kernel, entered through _surfel_bwd_call) together with its
// side-carry blocks and the XLA scatter that reduced its per-key blocks onto
// surfels (pallas_surfel_train.py:843-863 and :928-936, through
// pallas.py:compact_block_scatter). Plain PyTorch version:
// scorp_tpu_torch/ops/raster/surfel_backward.py:surfel_backward_plain.
//
// Input: the stream data[K][21] that K5 read (surfel_common.cuh gives the
// row layout), gid[K] the surfel row of each stream slot, the per-tile
// ranges, bg[3], the cotangents of K5's six outputs (g_color and g_normal
// [T][3][256], g_alpha, g_depth, g_median and g_dist [T][1][256]) and K5's
// residuals t_final, n_contrib, n_med, wm = sum w m and wm2 = sum w m^2.
// Output: d_table[N][21] += the gradient of every stream row, summed over
// pixels and over the slots of each surfel (the wrapper zeroes it first).
//
// Per pixel, keys j < n_contrib are walked back to front. T is rebuilt by
// division, T_before = T / (1 - alpha), starting from t_final, and the
// suffix S = sum_{k>j} w_k u_k is kept in a register. With A = 1 - T_final
// (= sum w), D = wm, D2 = wm2 and the closed-form distortion VJP of
// pallas_surfel_train.py:14-17 (prefix and suffix sums telescope into the
// totals):
//   psi    = m^2 (A - w) + (D2 - w m^2) - 2 m (D - w m)      = dL_dist/dw
//   u      = c.g_C + n.g_N + z g_D + g_dist psi
//   dalpha = T_before u - (S + T_final (bg.g_C - g_A)) / (1 - alpha)
//   dz     = w g_D + g_dist 2 w (m (A - w) - (D - w m)) dm/dz
//            + g_med at the median key (position n_med) only
//   drho   = -alpha_u dalpha / 2, alpha_u = 2^(NC rho + lopa) (the gradient
//            passes the 0.99 clamp, as in the CUDA reference)
// then through rho = min(rho3d, rho2d), z = use3d ? u zu + v zv + zc : zc,
// the u/v clip and the s_z clamp (each gates its gradient as the JAX
// package's autodiff does), and s = adj (px, py, 1). The 21 columns: d_adj
// (rows of ds (px, py, 1)), d_zu, d_zv, d_zc, d_cx, d_cy, d_color = sum w
// g_C, d_normal = sum w g_N, d_lopa = -2 ln2 sum drho. alpha and z come from
// surfel_common.cuh, the expression K5 evaluates, built with the same
// -fmad=false flags, so the 1/255 and z >= 0.2 tests agree with K5's bit for
// bit; keys failing them, and keys at positions >= n_contrib (the 1-based
// last contributor, counting skipped keys), emit nothing. Slots past a
// tile's range are never read. The divisions by 1 - alpha, sz and z are
// multiplications by one reciprocal each (m shares z's), so K6's T, m and
// ds differ from the plain version's by an ulp or so; it is held per column
// at 1e-4 of the column's largest value.
//
// What bounds it on an H100: the instruction rate. Every (warp, key) slot in
// which a lane emits pays the geometry, hit(), the ~110 f32 operations of
// the gradient and a reduction of its 21 partials over the warp; at full
// width 65% of the walked slots emit nothing. Bytes are small beside it:
// each key is read once (88 B with its gid).
//
// Design: as K3, one block of 256 threads per tile, one thread per pixel.
// The block takes the tile's largest n_contrib and stages keys 256 at a time
// from the top down by a coalesced copy; every thread reads the same key at
// once, a broadcast, and a warp skips the keys above its own largest
// n_contrib. Then:
// - the dead slots are skipped as in K4/K5 (surfel_common.cuh): per batch,
//   thread i evaluates key i's warp_mask(), and a warp whose bit is clear
//   skips the key for one shared byte; then the division-free may_hit()
//   runs before hit(), and a warp in which no lane below its n_contrib
//   passes it skips the key;
// - a key in which some lane emits is reduced by a reduce-scatter: the 21
//   partials padded to 32, five rounds that exchange 16, 8, 4, 2 and 1
//   values (31 shuffles), after which lane c holds the warp's column c;
// - lanes 0-20 add their columns into the key's row of a per-block
//   accumulator in shared memory (s_acc[256][21]), where the 8 warps meet;
//   after the batch, 21 consecutive threads per touched row add it to
//   d_table with one atomicAdd each (the -2 ln2 of column 20 applied
//   there): one coalesced RED per row and block.
// This replaces the TPU's chunk-grid gradient blocks, side carries and
// compact_block_scatter (and with them the TPU-only knob that sized those
// blocks), which existed because a TPU grid has no atomics; the order of
// the atomic adds changes from run to run, so K6 is not bit-identical to
// its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel_common.cuh"

namespace {

using namespace surfel;

constexpr int kWarps = kPix / 32;
constexpr unsigned kFull = 0xffffffffu;

// one round of the reduce-scatter: a lane keeps the half of r[0, 2H) that
// its lane bit H selects, sends the other half to lane ^ H and adds what it
// receives, so r[0, H) then holds partial sums of its half's columns
template <int H>
__device__ __forceinline__ void exchange_halves(float (&r)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? r[i] : r[i + H];
    const float keep = upper ? r[i + H] : r[i];
    r[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__global__ void __launch_bounds__(kPix) surfel_backward_kernel(
    const float* __restrict__ data, const int* __restrict__ gid,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ bg, const float* __restrict__ g_color,
    const float* __restrict__ g_alpha, const float* __restrict__ g_depth,
    const float* __restrict__ g_normal, const float* __restrict__ g_median,
    const float* __restrict__ g_dist, const float* __restrict__ t_final,
    const int* __restrict__ n_contrib, const int* __restrict__ n_med,
    const float* __restrict__ wm_total, const float* __restrict__ wm2_total, int tiles_x,
    float* __restrict__ d_table) {
  __shared__ float s_keys[kPix * kCols];
  __shared__ float s_acc[kPix * kCols];
  __shared__ int s_gid[kPix];
  __shared__ unsigned char s_mask[kPix];
  __shared__ int s_max[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = (t % tiles_x) * kTile, y0 = (t / tiles_x) * kTile;
  const float px = (float)(x0 + tid % kTile);
  const float py = (float)(y0 + tid / kTile);
  const unsigned warp_bit = 1u << (tid >> 5);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const size_t p = (size_t)t * kPix + tid;
  const size_t p3 = (size_t)t * 3 * kPix + tid;
  const int nc = n_contrib[p];
  const int nm = n_med[p];

  for (int i = tid; i < kPix * kCols; i += kPix) s_acc[i] = 0.0f;
  // the warp's and the tile's last key that any pixel included
  int warp_mx = nc;
  for (int o = 16; o > 0; o >>= 1) warp_mx = max(warp_mx, __shfl_xor_sync(kFull, warp_mx, o));
  if (lane == 0) s_max[tid >> 5] = warp_mx;
  __syncthreads();
  int mx = s_max[0];
  for (int w = 1; w < kWarps; ++w) mx = max(mx, s_max[w]);
  mx = min(mx, count);

  const float gc0 = g_color[p3], gc1 = g_color[p3 + kPix], gc2 = g_color[p3 + 2 * kPix];
  const float gn0 = g_normal[p3], gn1 = g_normal[p3 + kPix], gn2 = g_normal[p3 + 2 * kPix];
  const float gd = g_depth[p];
  const float gmed = g_median[p];
  const float gdist = g_dist[p];
  const float tf = t_final[p];
  const float a_all = 1.0f - tf;
  const float d_all = wm_total[p];
  const float d2_all = wm2_total[p];
  const float gt_term = tf * (bg[0] * gc0 + bg[1] * gc1 + bg[2] * gc2 - g_alpha[p]);
  float trans = tf;
  float suffix = 0.0f;

  for (int hi = mx; hi > 0; hi -= kPix) {
    const int lo = max(0, hi - kPix);
    const int n_batch = hi - lo;
    __syncthreads();  // every thread is done with the previous batch and its flush
    const float* src = data + ((size_t)start + lo) * kCols;
    for (int i = tid; i < n_batch * kCols; i += kPix) s_keys[i] = src[i];
    if (tid < n_batch) {
      s_gid[tid] = gid[start + lo + tid];
      s_mask[tid] = (unsigned char)warp_mask(src + tid * kCols, x0, y0);
    }
    __syncthreads();
    for (int jj = min(n_batch, warp_mx - lo) - 1; jj >= 0; --jj) {
      if (!(s_mask[jj] & warp_bit)) continue;  // warp-uniform
      const float* key = s_keys + jj * kCols;
      const int pos = lo + jj;
      const Geo g = geo(key, px, py);
      const bool may = pos < nc && may_hit(key, g);
      if (!__any_sync(kFull, may)) continue;  // warp-uniform
      float r[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) r[i] = 0.0f;
      bool emit = false;
      if (may) {
        const Hit h = hit(key, g);
        if (h.alpha >= kAlphaMin && h.z >= kNear) {
          emit = true;
          const float inv_om = 1.0f / (1.0f - h.alpha);
          const float t_before = trans * inv_om;
          const float w = h.alpha * t_before;
          const float izm = 1.0f / fmaxf(h.z, 1e-6f);
          const float m = kFF - kFFN * izm;
          const float wm = w * m;
          const float a_bar = a_all - w;
          const float d_bar = d_all - wm;
          const float d2_bar = d2_all - wm * m;
          const float psi = m * m * a_bar + d2_bar - 2.0f * m * d_bar;
          const float uu = key[14] * gc0 + key[15] * gc1 + key[16] * gc2 + key[17] * gn0 +
                           key[18] * gn1 + key[19] * gn2 + h.z * gd + gdist * psi;
          const float dalpha = t_before * uu - (suffix + gt_term) * inv_om;
          const float dmdz = kFFN * izm * izm;
          float dz = w * gd + gdist * 2.0f * w * (m * a_bar - d_bar) * dmdz;
          if (pos + 1 == nm) dz += gmed;
          const float drho = -0.5f * h.alpha_u * dalpha;
          float du = 0.0f, dv = 0.0f;
          if (h.use3d) {
            du = 2.0f * h.u * drho + key[9] * dz;
            dv = 2.0f * h.v * drho + key[10] * dz;
            r[9] = h.u * dz;
            r[10] = h.v * dz;
          } else {
            r[12] = 2.0f * kFilterInvSquare * g.dx * drho;
            r[13] = 2.0f * kFilterInvSquare * g.dy * drho;
          }
          if (!(h.u_raw >= -1e3f && h.u_raw <= 1e3f)) du = 0.0f;
          if (!(h.v_raw >= -1e3f && h.v_raw <= 1e3f)) dv = 0.0f;
          const float isz = 1.0f / g.sz;
          const float dsx = du * isz;
          const float dsy = dv * isz;
          const float dsz = fabsf(g.s_z) > 1e-9f ? -(h.u * du + h.v * dv) * isz : 0.0f;
          r[0] = dsx * px;
          r[1] = dsx * py;
          r[2] = dsx;
          r[3] = dsy * px;
          r[4] = dsy * py;
          r[5] = dsy;
          r[6] = dsz * px;
          r[7] = dsz * py;
          r[8] = dsz;
          r[11] = dz;
          r[14] = w * gc0;
          r[15] = w * gc1;
          r[16] = w * gc2;
          r[17] = w * gn0;
          r[18] = w * gn1;
          r[19] = w * gn2;
          r[20] = drho;
          suffix += w * uu;
          trans = t_before;
        }
      }
      if (!__any_sync(kFull, emit)) continue;
      exchange_halves<16>(r, lane);
      exchange_halves<8>(r, lane);
      exchange_halves<4>(r, lane);
      exchange_halves<2>(r, lane);
      exchange_halves<1>(r, lane);
      if (lane < kCols) atomicAdd(s_acc + jj * kCols + lane, r[0]);
    }
    __syncthreads();
    // flush the batch's rows: consecutive threads on consecutive columns
    for (int i = tid; i < n_batch * kCols; i += kPix) {
      const float v = s_acc[i];
      if (v == 0.0f) continue;
      s_acc[i] = 0.0f;
      const int c = i % kCols;
      atomicAdd(d_table + (size_t)s_gid[i / kCols] * kCols + c,
                c == kCols - 1 ? -2.0f * kLn2 * v : v);
    }
  }
}

}  // namespace

extern "C" int scorp_surfel_backward(
    const void* data, const void* gid, const void* tile_start, const void* tile_count,
    const void* bg, const void* g_color, const void* g_alpha, const void* g_depth,
    const void* g_normal, const void* g_median, const void* g_dist, const void* t_final,
    const void* n_contrib, const void* n_med, const void* wm_total, const void* wm2_total,
    void* d_table, int num_tiles, int tiles_x, void* stream) {
  surfel_backward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)gid, (const int*)tile_start, (const int*)tile_count,
      (const float*)bg, (const float*)g_color, (const float*)g_alpha, (const float*)g_depth,
      (const float*)g_normal, (const float*)g_median, (const float*)g_dist,
      (const float*)t_final, (const int*)n_contrib, (const int*)n_med,
      (const float*)wm_total, (const float*)wm2_total, tiles_x, (float*)d_table);
  return (int)cudaGetLastError();
}
