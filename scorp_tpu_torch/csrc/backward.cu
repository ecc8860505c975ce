// Kernel K3: backward compositor, the reverse walk of K2 per tile.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_bwd.py:87
// (_bwd_kernel, entered through backward_kernel_call) together with the XLA
// scatter that reduced its per-key blocks onto gaussians
// (pallas.py:72 compact_block_scatter). Plain PyTorch version:
// scorp_tpu_torch/ops/raster/backward.py:composite_backward_plain.
//
// Input: the stream data[K][10] that K2 read (gauss_common.cuh gives the row
// layout), gid[K] the gaussian row of each stream slot, the per-tile ranges,
// bg[3], the cotangents g_color [T][3][256], g_depth and g_alpha
// [T][1][256], and K2's residuals t_final (the final transmittance) and
// n_contrib. Output: d_table[N][10] += the gradient of every stream row,
// summed over pixels and over the slots of each gaussian (the wrapper zeroes
// it first).
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
// alpha comes from gauss_common.cuh:alpha_of, the expression K2 evaluates,
// built with the same -fmad=false flags, so the 1/255 skip test agrees with
// K2's bit for bit; keys with alpha < 1/255 and at positions >= n_contrib
// (the 1-based last contributor, counting skipped keys) emit nothing. Slots
// past a tile's range are never read, so the meaningless gid of stream slots
// past the kept total never is either. The two divisions by 1 - alpha are
// multiplications by one reciprocal, and d_gx, d_gy are summed as
// l11 su dpow and l21 su dpow + l22 sv dpow per pixel (the conic folded in
// before the sum, the ln2 and the sign after it), so K3 differs from the
// plain version by an ulp or so per term; it is held per column at 1e-4 of
// the column's largest value.
//
// What bounds it on an H100: the instruction rate. Every (warp, key) slot
// below the warp's largest n_contrib in which a lane emits pays the alpha,
// ~30 f32 operations of gradient and a reduction of its 10 partials over
// the warp; a key K1 admits to a 16x16 tile often misses a warp's 2 pixel
// rows, and such slots emit nothing. Bytes are small beside it: each key is
// read once (44 B with its gid).
//
// Design: as K2, one block of 256 threads per tile, one thread per pixel.
// The block takes the tile's largest n_contrib and stages keys 256 at a time
// from the top down by a coalesced copy, with their gids; every thread reads
// the same key at once, a broadcast. While staging, thread i evaluates key
// i's gauss_common.cuh:warp_mask(). Then:
// - a warp walks only up to its own largest n_contrib, and skips a key
//   whose warp_mask bit is clear for one shared byte;
// - a key in which some lane emits is reduced by a reduce-scatter: the 10
//   partials padded to 16, four rounds that exchange 8, 4, 2 and 1 values
//   and one shuffle across the half-warps (16 shuffles), after which lane
//   c < 10 holds the warp's column c;
// - lanes 0-9 add their columns into the key's row of a per-block
//   accumulator in shared memory (s_acc[256][10]), where the 8 warps meet;
//   after the batch, consecutive threads add each touched row to d_table
//   with one atomicAdd per column (the -ln2 of columns 0-4 and the ln2 of
//   column 9 applied there): one coalesced RED per row and block.
// Staging by double-buffered cp.async into 48-byte rows read as float4, as
// K2 does, was measured slower here: K3 walks one or two batches per tile.
// This replaces the TPU's chunk-grid blocks, its side-carry outputs and
// compact_block_scatter, which existed because a TPU grid has no atomics;
// the order of the atomic adds changes from run to run, so K3 is not
// bit-identical to its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gauss_common.cuh"

namespace {

using namespace gauss;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 16;  // columns through the reduce-scatter

// one round of the reduce-scatter: a lane keeps the half of r[0, 2H) that
// its lane bit H selects, sends the other half to lane ^ H and adds what it
// receives, so r[0, H) then holds partial sums of its half's columns
template <int H>
__device__ __forceinline__ void exchange_halves(float (&r)[kPad], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? r[i] : r[i + H];
    const float keep = upper ? r[i + H] : r[i];
    r[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__global__ void __launch_bounds__(kPix) composite_backward_kernel(
    const float* __restrict__ data, const int* __restrict__ gid,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ bg, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    const float* __restrict__ t_final, const int* __restrict__ n_contrib, int tiles_x,
    float* __restrict__ d_table) {
  __shared__ float s_keys[kPix * kRows];
  __shared__ float s_acc[kPix * kRows];
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
  const int nc = n_contrib[p];
  const float* src = data + (size_t)start * kRows;

  for (int i = tid; i < kPix * kRows; i += kPix) s_acc[i] = 0.0f;
  // the warp's and the tile's last key that any pixel included
  int warp_mx = nc;
  for (int o = 16; o > 0; o >>= 1) warp_mx = max(warp_mx, __shfl_xor_sync(kFull, warp_mx, o));
  if (lane == 0) s_max[tid >> 5] = warp_mx;
  __syncthreads();
  int mx = s_max[0];
  for (int w = 1; w < kWarps; ++w) mx = max(mx, s_max[w]);
  mx = min(mx, count);

  const float gc0 = g_color[((size_t)t * 3 + 0) * kPix + tid];
  const float gc1 = g_color[((size_t)t * 3 + 1) * kPix + tid];
  const float gc2 = g_color[((size_t)t * 3 + 2) * kPix + tid];
  const float gd = g_depth[p];
  const float tf = t_final[p];
  const float gt_term = tf * (bg[0] * gc0 + bg[1] * gc1 + bg[2] * gc2 - g_alpha[p]);
  float trans = tf;
  float suffix = 0.0f;

  for (int hi = mx; hi > 0; hi -= kPix) {
    const int lo = max(0, hi - kPix);
    __syncthreads();  // every thread is done with the previous batch and its flush
    const float* src_b = src + (size_t)lo * kRows;
    for (int i = tid; i < (hi - lo) * kRows; i += kPix) s_keys[i] = src_b[i];
    if (tid < hi - lo) {
      s_gid[tid] = gid[start + lo + tid];
      s_mask[tid] = (unsigned char)warp_mask(geo_of(src_b + kRows * tid), x0, y0);
    }
    __syncthreads();
    for (int jj = min(hi, warp_mx) - lo - 1; jj >= 0; --jj) {
      if (!(s_mask[jj] & warp_bit)) continue;  // warp-uniform
      const float* key = s_keys + kRows * jj;
      float r[kPad];
#pragma unroll
      for (int i = 0; i < kPad; ++i) r[i] = 0.0f;
      bool emit = false;
      if (lo + jj < nc) {
        const Geo k = geo_of(key);
        const Alpha a = alpha_of(k, px, py);
        if (a.alpha >= kAlphaMin) {
          emit = true;
          const float inv_om = 1.0f / (1.0f - a.alpha);
          const float t_before = trans * inv_om;
          const float w = a.alpha * t_before;
          const float cu = key[5] * gc0 + key[6] * gc1 + key[7] * gc2 + key[8] * gd;
          const float dalpha = t_before * cu - (suffix + gt_term) * inv_om;
          const float dpow = a.alpha_u * dalpha;
          const float ud = a.u * dpow;
          const float vd = a.v * dpow;
          r[0] = k.l11 * ud;
          r[1] = k.l21 * ud + k.l22 * vd;
          r[2] = ud * a.dx;
          r[3] = ud * a.dy;
          r[4] = vd * a.dy;
          r[5] = w * gc0;
          r[6] = w * gc1;
          r[7] = w * gc2;
          r[8] = w * gd;
          r[9] = dpow;
          suffix += w * cu;
          trans = t_before;
        }
      }
      if (!__any_sync(kFull, emit)) continue;  // warp-uniform
      exchange_halves<8>(r, lane);
      exchange_halves<4>(r, lane);
      exchange_halves<2>(r, lane);
      exchange_halves<1>(r, lane);
      r[0] += __shfl_xor_sync(kFull, r[0], 16);
      if (lane < kRows) atomicAdd(s_acc + jj * kRows + lane, r[0]);
    }
    __syncthreads();
    // flush the batch's rows: consecutive threads on consecutive columns
    const int* rows = s_gid;
    for (int i = tid; i < (hi - lo) * kRows; i += kPix) {
      const float v = s_acc[i];
      if (v == 0.0f) continue;
      s_acc[i] = 0.0f;
      const int c = i % kRows;
      atomicAdd(d_table + (size_t)rows[i / kRows] * kRows + c,
                c < 5 ? -kLn2 * v : (c == 9 ? kLn2 * v : v));
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
