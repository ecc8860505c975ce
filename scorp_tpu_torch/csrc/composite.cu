// Kernel K2: forward compositor, front-to-back alpha blending per tile.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_fwd.py:415
// (_fwd_kernel, entered through _composite_kernel_call). Plain PyTorch
// version: scorp_tpu_torch/ops/raster/composite.py:composite_plain.
//
// Input: the depth-ordered key stream data[K][10] (xy, conic Cholesky rows
// scaled by sqrt(log2 e), rgb, view depth, log2 opacity), per-tile ranges
// tile_start/tile_count, and bg[3]. Output per tile t and pixel p (row-major
// in the 16x16 tile): color[t][c][p] = sum w c + T bg, depth[t][0][p] =
// sum w z, alpha[t][0][p] = 1 - T and, if n_contrib is non-null, the
// 1-based stream position of the last included key; if t_final is non-null,
// the final transmittance T itself (the CUDA reference's final_T: the
// backward kernel K3 rebuilds every T_before by division from it, and
// 1 - alpha would lose its relative precision once T nears the 1e-4 stop).
//
// Numerics (as the JAX package): alpha = min(0.99, exp2(lopa - (u^2+v^2)/2));
// alpha < 1/255 is skipped; a key is included iff T (1 - alpha) >= 1e-4,
// and the first key that would cross that threshold ends the pixel.
//
// What bounds it on an H100: the per (pixel, key) arithmetic (~20 f32 ops
// and one exp2) until the pixels saturate; every key is read from device
// memory once (40 B), so bytes are small beside it.
//
// Design: one block of 256 threads per tile, one thread per pixel. The
// block stages 256 keys at a time in shared memory with a coalesced copy of
// the contiguous rows, then every thread walks them in order; all threads
// read the same key at once, a shared-memory broadcast. The block stops
// once every pixel is done (__syncthreads_count), as the CUDA reference's
// renderCUDA does. The TPU kernel evaluated chunks of 128 keys as [256,128]
// vector blocks with the transmittance as a log-space triangular matmul
// scan, because the TPU has no per-pixel scalar threads; here the
// transmittance is a plain running product in a register.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kRows = 10;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix) composite_kernel(
    const float* __restrict__ data, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ bg, int tiles_x,
    float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_alpha, int* __restrict__ out_ncontrib,
    float* __restrict__ out_tfinal) {
  __shared__ float s_keys[kPix * kRows];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((t % tiles_x) * kTile + (tid % kTile));
  const float py = (float)((t / tiles_x) * kTile + (tid / kTile));
  const int start = tile_start[t];
  const int count = tile_count[t];

  float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  int last = 0;
  bool done = false;
  for (int b = 0; b < count; b += kPix) {
    // block-uniform exit; also the barrier before s_keys is overwritten
    if (__syncthreads_count(done) == kPix) break;
    const int n_batch = min(kPix, count - b);
    const float* src = data + ((size_t)start + b) * kRows;
    for (int i = tid; i < n_batch * kRows; i += kPix) s_keys[i] = src[i];
    __syncthreads();
    for (int j = 0; j < n_batch && !done; ++j) {
      const float* key = s_keys + j * kRows;
      const float dx = key[0] - px;
      const float dy = key[1] - py;
      const float u = key[2] * dx + key[3] * dy;
      const float v = key[4] * dy;
      const float power = -0.5f * (u * u + v * v);
      const float alpha = fminf(kAlphaMax, exp2f(power + key[9]));
      if (alpha < kAlphaMin) continue;
      const float test_t = trans * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      c0 += w * key[5];
      c1 += w * key[6];
      c2 += w * key[7];
      dep += w * key[8];
      trans = test_t;
      last = b + j + 1;
    }
  }

  const size_t p = (size_t)t * kPix + tid;
  out_color[((size_t)t * 3 + 0) * kPix + tid] = c0 + trans * bg[0];
  out_color[((size_t)t * 3 + 1) * kPix + tid] = c1 + trans * bg[1];
  out_color[((size_t)t * 3 + 2) * kPix + tid] = c2 + trans * bg[2];
  out_depth[p] = dep;
  out_alpha[p] = 1.0f - trans;
  if (out_ncontrib != nullptr) out_ncontrib[p] = last;
  if (out_tfinal != nullptr) out_tfinal[p] = trans;
}

}  // namespace

extern "C" int scorp_composite(const void* data, const void* tile_start,
                               const void* tile_count, const void* bg, int num_tiles,
                               int tiles_x, void* out_color, void* out_depth,
                               void* out_alpha, void* out_ncontrib, void* out_tfinal,
                               void* stream) {
  composite_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const int*)tile_start, (const int*)tile_count,
      (const float*)bg, tiles_x, (float*)out_color, (float*)out_depth,
      (float*)out_alpha, (int*)out_ncontrib, (float*)out_tfinal);
  return (int)cudaGetLastError();
}
