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
// What bounds it on an H100: the instruction rate, one warp walking the keys
// in order per 2 pixel rows. A walked (warp, key) slot with a live lane
// costs ~150 warp instructions (the geometry's 12 shared loads and 20 f32
// operations, hit() with two divisions and an exp2, the blend with the
// distortion's division); at full width 65% of the walked slots have no
// lane at alpha >= 1/255, and each key is read from device memory once
// (84 B), so bytes are small beside the instructions.
//
// Design: as K2, one block of 256 threads per tile, one thread per pixel,
// 256 keys at a time in shared memory (21.5 KB), every thread reading the
// same key at once (a broadcast); the running sums live in registers. The
// dead slots are skipped before their geometry is paid for
// (surfel_common.cuh):
// - per batch, thread i evaluates key i's warp_mask(); a warp whose bit is
//   clear skips the key for one shared byte (52% of the walked slots at
//   full width);
// - a warp evaluates the division-free may_hit() next and skips the key
//   when no lane that is not done passes it (the exact tests in hit()
//   still decide for the others, so the included keys are those of the
//   plain version); a warp whose lanes are all done leaves the batch.
// The batches are double-buffered: the next 256 keys are copied with
// cp.async (4 B per thread and copy, coalesced; rows are 84 B, so no 16 B
// alignment holds for TMA) and their masks evaluated while the current ones
// are blended, one barrier per batch, and the block stops at a batch
// boundary once every pixel is done.
// The TPU kernel evaluated chunks of keys as [256, C] vector blocks, with
// the transmittance as a log-space triangular matmul scan and the
// distortion telescoped into chunk sums, because the TPU has no per-pixel
// scalar threads; here every sum is a plain sequential update per pixel.
// The TPU stream's 3 padding rows are dropped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel_common.cuh"

namespace {

using namespace surfel;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// every thread copies its share of keys [b, b + 256) of the tile into buf
// and commits them as one cp.async group; then, while they are in flight,
// thread i evaluates key b + i's warp_mask from device memory
__device__ __forceinline__ void stage_async(float* buf, unsigned char* mask,
                                            const float* __restrict__ data, int start, int b,
                                            int count, int tid, int x0, int y0) {
  const int n = min(kPix, count - b) * kCols;
  const float* src = data + ((size_t)start + b) * kCols;
  for (int i = tid; i < n; i += kPix) copy_async4(buf + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (b + tid < count) mask[tid] = (unsigned char)warp_mask(src + tid * kCols, x0, y0);
}

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
  __shared__ float s_keys[2][kPix * kCols];
  __shared__ unsigned char s_mask[2][kPix];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int x0 = (t % tiles_x) * kTile, y0 = (t / tiles_x) * kTile;
  const float px = (float)(x0 + tid % kTile);
  const float py = (float)(y0 + tid / kTile);
  const unsigned warp_bit = 1u << (tid >> 5);
  const int start = tile_start[t];
  const int count = tile_count[t];

  float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, med = 0.0f, dist = 0.0f;
  float a_run = 0.0f, d_run = 0.0f, d2_run = 0.0f;
  int last = 0, n_med = 0;
  bool done = false;
  if (count > 0) stage_async(s_keys[0], s_mask[0], data, start, 0, count, tid, x0, y0);
  for (int b = 0, buf = 0; b < count; b += kPix, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // one barrier per batch: this thread's copies have landed, everyone's
    // copies and masks are visible, every warp is done with the other
    // buffer, and the exit is block-uniform
    if (__syncthreads_count(done) == kPix) break;
    if (b + kPix < count) {
      stage_async(s_keys[buf ^ 1], s_mask[buf ^ 1], data, start, b + kPix, count, tid, x0, y0);
    }
    const float* keys = s_keys[buf];
    const unsigned char* mask = s_mask[buf];
    const int n_batch = min(kPix, count - b);
    for (int j = 0; j < n_batch; ++j) {
      if (!(mask[j] & warp_bit)) continue;  // warp-uniform
      const float* key = keys + j * kCols;
      const Geo g = geo(key, px, py);
      const bool may = !done && may_hit(key, g);
      if (!__any_sync(kFull, may)) {  // warp-uniform
        if (__all_sync(kFull, done)) break;
        continue;
      }
      if (!may) continue;
      const Hit h = hit(key, g);
      if (h.alpha < kAlphaMin || h.z < kNear) continue;
      const float test_t = trans * (1.0f - h.alpha);
      if (test_t < kTEps) {
        done = true;
        continue;
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
