// Kernel K3: backward compositor, the reverse walk of K2 per tile.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_bwd.py:87
// (_bwd_kernel, entered through backward_kernel_call) together with the XLA
// scatter that reduced its per-key blocks onto gaussians
// (pallas.py:72 compact_block_scatter). Plain PyTorch version:
// scorp_tpu_torch/ops/raster/backward.py:composite_backward_plain.
//
// Input: the stream data[K][10] that K2 read (xy, conic Cholesky rows scaled
// by sqrt(log2 e), rgb, view depth, log2 opacity), gid[K] the gaussian row of
// each stream slot, the per-tile ranges, bg[3], the cotangents g_color
// [T][3][256], g_depth and g_alpha [T][1][256], and K2's residuals t_final
// (the final transmittance) and n_contrib. Output: d_table[N][10] += the
// gradient of every stream row, summed over pixels and over the slots of each
// gaussian (the wrapper zeroes it first).
//
// Per pixel, keys j < n_contrib are walked back to front. T is rebuilt by
// division, T_before = T / (1 - alpha), starting from t_final, as the CUDA
// reference's renderCUDA backward does, and the suffix S = sum_{k>j} w_k u_k
// is kept in a register. Per key, with u = c.g_C + z g_D and
// gt_term = T_final (bg.g_C - g_A):
//   dalpha = T_before u - (S + gt_term) / (1 - alpha)
//   dpow   = alpha_u dalpha, alpha_u = exp2(power + lopa) (the gradient
//            passes the 0.99 clamp, as in the reference)
// and the rows d_gx = -l11 r_u, d_gy = -(l21 r_u + l22 r_v),
// d_l11 = -ln2 sum su dpow dx, d_l21 = -ln2 sum su dpow dy,
// d_l22 = -ln2 sum sv dpow dy, d_rgb = sum w g_C, d_z = sum w g_D,
// d_lopa = ln2 sum dpow, with r_u = ln2 sum su dpow, r_v = ln2 sum sv dpow.
// alpha is evaluated by the expression of composite.cu, in the same order and
// with the same -fmad=false build, so the 1/255 skip test agrees with K2's
// bit for bit; keys with alpha < 1/255 and at positions >= n_contrib (the
// 1-based last contributor, counting skipped keys) emit nothing. Slots past a
// tile's range are never read, so the meaningless gid of stream slots past
// the kept total never is either.
//
// What bounds it on an H100: the per (pixel, key) arithmetic up to each
// pixel's n_contrib (~45 f32 ops and one exp2 per pair), then the atomics:
// each warp that has a contributing pixel for a key adds 10 floats into the
// key's gaussian row, up to 8 warps x 10 atomics per kept key. Bytes are
// small beside both: each key is read once (44 B with its gid).
//
// Design: one block of 256 threads per tile, one thread per pixel, as K2.
// The block takes the tile's largest n_contrib (warp shuffles, then shared
// memory) and stages keys 256 at a time, from the top down, by a coalesced
// copy; every thread reads the same key at once, a broadcast. A key's 10
// partial sums are reduced across the warp with __shfl_xor_sync only when
// some lane of the warp contributes (__any_sync), and lane 0 adds them with
// atomicAdd. This replaces the TPU's chunk-grid blocks, its side-carry
// outputs and compact_block_scatter, which existed because a TPU grid has no
// atomics; the order of the atomic adds changes from run to run, so K3 is
// not bit-identical to its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kRows = 10;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kPix) composite_backward_kernel(
    const float* __restrict__ data, const int* __restrict__ gid,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ bg, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    const float* __restrict__ t_final, const int* __restrict__ n_contrib, int tiles_x,
    float* __restrict__ d_table) {
  __shared__ float s_keys[kPix * kRows];
  __shared__ int s_gid[kPix];
  __shared__ int s_max[kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float px = (float)((t % tiles_x) * kTile + (tid % kTile));
  const float py = (float)((t / tiles_x) * kTile + (tid / kTile));
  const int start = tile_start[t];
  const int count = tile_count[t];
  const size_t p = (size_t)t * kPix + tid;
  const int nc = n_contrib[p];

  // the tile's last key that any pixel included
  int m = nc;
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) s_max[tid >> 5] = m;
  __syncthreads();
  m = s_max[0];
  for (int w = 1; w < kWarps; ++w) m = max(m, s_max[w]);
  m = min(m, count);

  const float gc0 = g_color[((size_t)t * 3 + 0) * kPix + tid];
  const float gc1 = g_color[((size_t)t * 3 + 1) * kPix + tid];
  const float gc2 = g_color[((size_t)t * 3 + 2) * kPix + tid];
  const float gd = g_depth[p];
  const float tf = t_final[p];
  const float gt_term = tf * (bg[0] * gc0 + bg[1] * gc1 + bg[2] * gc2 - g_alpha[p]);
  float trans = tf;
  float suffix = 0.0f;

  for (int hi = m; hi > 0; hi -= kPix) {
    const int lo = max(0, hi - kPix);
    const int n_batch = hi - lo;
    __syncthreads();  // every thread is done with the previous batch
    const float* src = data + ((size_t)start + lo) * kRows;
    for (int i = tid; i < n_batch * kRows; i += kPix) s_keys[i] = src[i];
    if (tid < n_batch) s_gid[tid] = gid[start + lo + tid];
    __syncthreads();
    for (int jj = n_batch - 1; jj >= 0; --jj) {
      const float* key = s_keys + jj * kRows;
      float r[kRows] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool emit = false;
      if (lo + jj < nc) {
        const float dx = key[0] - px;
        const float dy = key[1] - py;
        const float u = key[2] * dx + key[3] * dy;
        const float v = key[4] * dy;
        const float power = -0.5f * (u * u + v * v);
        const float alpha_u = exp2f(power + key[9]);
        const float alpha = fminf(kAlphaMax, alpha_u);
        if (alpha >= kAlphaMin) {
          emit = true;
          const float one_minus = 1.0f - alpha;
          const float t_before = trans / one_minus;
          const float w = alpha * t_before;
          const float cu = key[5] * gc0 + key[6] * gc1 + key[7] * gc2 + key[8] * gd;
          const float dalpha = t_before * cu - (suffix + gt_term) / one_minus;
          const float dpow = alpha_u * dalpha;
          const float ud = u * dpow;
          const float vd = v * dpow;
          r[0] = ud;
          r[1] = vd;
          r[2] = ud * dx;
          r[3] = ud * dy;
          r[4] = vd * dy;
          r[5] = w * gc0;
          r[6] = w * gc1;
          r[7] = w * gc2;
          r[8] = w * gd;
          r[9] = dpow;
          suffix += w * cu;
          trans = t_before;
        }
      }
      if (__any_sync(kFull, emit)) {  // warp-uniform: jj is block-uniform
#pragma unroll
        for (int i = 0; i < kRows; ++i) r[i] = warp_sum(r[i]);
        if (lane == 0) {
          float* row = d_table + (size_t)s_gid[jj] * kRows;
          const float r_u = kLn2 * r[0];
          const float r_v = kLn2 * r[1];
          atomicAdd(row + 0, -(key[2] * r_u));
          atomicAdd(row + 1, -(key[3] * r_u + key[4] * r_v));
          atomicAdd(row + 2, -kLn2 * r[2]);
          atomicAdd(row + 3, -kLn2 * r[3]);
          atomicAdd(row + 4, -kLn2 * r[4]);
          atomicAdd(row + 5, r[5]);
          atomicAdd(row + 6, r[6]);
          atomicAdd(row + 7, r[7]);
          atomicAdd(row + 8, r[8]);
          atomicAdd(row + 9, kLn2 * r[9]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int scorp_composite_backward(
    const void* data, const void* gid, const void* tile_start, const void* tile_count,
    const void* bg, const void* g_color, const void* g_depth, const void* g_alpha,
    const void* t_final, const void* n_contrib, void* d_table, int num_tiles, int tiles_x,
    void* stream) {
  composite_backward_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)gid, (const int*)tile_start, (const int*)tile_count,
      (const float*)bg, (const float*)g_color, (const float*)g_depth, (const float*)g_alpha,
      (const float*)t_final, (const int*)n_contrib, tiles_x, (float*)d_table);
  return (int)cudaGetLastError();
}
