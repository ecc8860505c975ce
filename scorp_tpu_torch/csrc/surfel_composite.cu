// Kernels K4 and K5: the surfel forward compositor, front-to-back blending
// of the 7-channel allmap per tile.
//
// K4 (scorp_surfel_composite, eval) replaces the TPU kernel
// scorp_tpu/ops/raster/pallas_surfel.py:136 (_surfel_fwd_kernel, entered
// through _surfel_kernel_call). K5 (scorp_surfel_composite_train) replaces
// scorp_tpu/ops/raster/pallas_surfel_train.py:131 (_surfel_train_fwd_kernel,
// entered through _surfel_train_fwd_call). One templated body serves both.
// Plain PyTorch version:
// scorp_tpu_torch/ops/raster/surfel_composite.py:surfel_composite_plain.
//
// Input: the depth-ordered key stream data[K][21] (surfel_common.cuh gives
// the row layout), per-tile ranges tile_start/tile_count, and bg[3]. Output
// per tile t and pixel p (row-major in the 16x16 tile): color = sum w c +
// T bg, alpha = 1 - T, depth = sum w z, normal = sum w n, median = z of the
// last included key whose entry transmittance exceeds 0.5, and the
// distortion sum_i w_i (m_i^2 A + D2 - 2 m_i D) over the running sums A, D,
// D2 of w, w m, w m^2. K5 also writes n_contrib (1-based position of the
// last included key), n_med (position of the median key, 0 if none), the
// totals D = sum w m and D2 = sum w m^2, and the final transmittance T
// itself (K6 rebuilds every T_before by division from it; 1 - alpha would
// lose its relative precision as T nears the 1e-4 stop).
//
// Numerics (surfel_common.cuh and ops/raster/surfel.py): keys with alpha <
// 1/255 or z < 0.2 are skipped; a key is included iff T (1 - alpha) >=
// 1e-4, and the first key that would cross that threshold ends the pixel.
//
// What bounds it on an H100: the per (pixel, key) arithmetic, ~45 f32
// operations, two divisions and one exp2 per evaluated pair, until the
// pixels saturate; each key is read from device memory once (84 B), so bytes
// are small beside it.
//
// Design: as K2, one block of 256 threads per tile, one thread per pixel.
// The block stages 256 keys at a time in shared memory (21.5 KB) with a
// coalesced copy of the contiguous rows, and every thread walks them in
// order, reading the same key at once (a shared-memory broadcast); the
// running sums live in registers and the block stops once every pixel is
// done. The TPU kernel evaluated chunks of keys as [256, C] vector blocks,
// with the transmittance as a log-space triangular matmul scan and the
// distortion telescoped into chunk sums, because the TPU has no per-pixel
// scalar threads; here every sum is a plain sequential update per pixel.
// The TPU stream's 3 padding rows are dropped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel_common.cuh"

namespace {

using namespace surfel;

template <bool kTrain>
__global__ void __launch_bounds__(kPix) surfel_composite_kernel(
    const float* __restrict__ data, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ bg, int tiles_x,
    float* __restrict__ out_color, float* __restrict__ out_alpha,
    float* __restrict__ out_depth, float* __restrict__ out_normal,
    float* __restrict__ out_median, float* __restrict__ out_dist,
    int* __restrict__ out_ncontrib, int* __restrict__ out_nmed,
    float* __restrict__ out_wm, float* __restrict__ out_wm2,
    float* __restrict__ out_tfinal) {
  __shared__ float s_keys[kPix * kCols];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((t % tiles_x) * kTile + (tid % kTile));
  const float py = (float)((t / tiles_x) * kTile + (tid / kTile));
  const int start = tile_start[t];
  const int count = tile_count[t];

  float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, med = 0.0f, dist = 0.0f;
  float a_run = 0.0f, d_run = 0.0f, d2_run = 0.0f;
  int last = 0, n_med = 0;
  bool done = false;
  for (int b = 0; b < count; b += kPix) {
    // block-uniform exit; also the barrier before s_keys is overwritten
    if (__syncthreads_count(done) == kPix) break;
    const int n_batch = min(kPix, count - b);
    const float* src = data + ((size_t)start + b) * kCols;
    for (int i = tid; i < n_batch * kCols; i += kPix) s_keys[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n_batch && !done; ++j) {
      const float* key = s_keys + j * kCols;
      const Hit h = hit(key, px, py);
      if (h.alpha < kAlphaMin || h.z < kNear) continue;
      const float test_t = trans * (1.0f - h.alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = h.alpha * trans;
      c0 += w * key[14];
      c1 += w * key[15];
      c2 += w * key[16];
      n0 += w * key[17];
      n1 += w * key[18];
      n2 += w * key[19];
      dep += w * h.z;
      if (trans > 0.5f) {
        med = h.z;
        n_med = b + j + 1;
      }
      const float m = distortion_m(h.z);
      dist += w * (m * m * a_run + d2_run - 2.0f * m * d_run);
      const float wm = w * m;
      a_run += w;
      d_run += wm;
      d2_run += wm * m;
      trans = test_t;
      last = b + j + 1;
    }
  }

  const size_t p = (size_t)t * kPix + tid;
  const size_t p3 = (size_t)t * 3 * kPix + tid;
  out_color[p3] = c0 + trans * bg[0];
  out_color[p3 + kPix] = c1 + trans * bg[1];
  out_color[p3 + 2 * kPix] = c2 + trans * bg[2];
  out_alpha[p] = 1.0f - trans;
  out_depth[p] = dep;
  out_normal[p3] = n0;
  out_normal[p3 + kPix] = n1;
  out_normal[p3 + 2 * kPix] = n2;
  out_median[p] = med;
  out_dist[p] = dist;
  if constexpr (kTrain) {
    out_ncontrib[p] = last;
    out_nmed[p] = n_med;
    out_wm[p] = d_run;
    out_wm2[p] = d2_run;
    out_tfinal[p] = trans;
  }
}

}  // namespace

extern "C" int scorp_surfel_composite(const void* data, const void* tile_start,
                                      const void* tile_count, const void* bg, int num_tiles,
                                      int tiles_x, void* out_color, void* out_alpha,
                                      void* out_depth, void* out_normal, void* out_median,
                                      void* out_dist, void* stream) {
  surfel_composite_kernel<false><<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)tile_start, (const int*)tile_count, (const float*)bg,
      tiles_x, (float*)out_color, (float*)out_alpha, (float*)out_depth, (float*)out_normal,
      (float*)out_median, (float*)out_dist, nullptr, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int scorp_surfel_composite_train(
    const void* data, const void* tile_start, const void* tile_count, const void* bg,
    int num_tiles, int tiles_x, void* out_color, void* out_alpha, void* out_depth,
    void* out_normal, void* out_median, void* out_dist, void* out_ncontrib, void* out_nmed,
    void* out_wm, void* out_wm2, void* out_tfinal, void* stream) {
  surfel_composite_kernel<true><<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)tile_start, (const int*)tile_count, (const float*)bg,
      tiles_x, (float*)out_color, (float*)out_alpha, (float*)out_depth, (float*)out_normal,
      (float*)out_median, (float*)out_dist, (int*)out_ncontrib, (int*)out_nmed,
      (float*)out_wm, (float*)out_wm2, (float*)out_tfinal);
  return (int)cudaGetLastError();
}
