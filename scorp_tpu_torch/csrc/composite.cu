// Kernel K2: forward compositor, front-to-back alpha blending per tile.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_fwd.py:415
// (_fwd_kernel, entered through _composite_kernel_call). Plain PyTorch
// version: scorp_tpu_torch/ops/raster/composite.py:composite_plain.
//
// Input: the depth-ordered key stream data[K][10] (gauss_common.cuh gives
// the row layout), per-tile ranges tile_start/tile_count, and bg[3]. Output
// per tile t and pixel p (row-major in the 16x16 tile): color[t][c][p] =
// sum w c + T bg, depth[t][0][p] = sum w z, alpha[t][0][p] = 1 - T and, if
// n_contrib is non-null, the 1-based stream position of the last included
// key; if t_final is non-null, the final transmittance T itself (the CUDA
// reference's final_T: the backward kernel K3 rebuilds every T_before by
// division from it, and 1 - alpha would lose its relative precision once T
// nears the 1e-4 stop).
//
// Numerics (as the JAX package): alpha = min(0.99, exp2(lopa - (u^2+v^2)/2))
// by gauss_common.cuh:alpha_of, the expression K3 evaluates; alpha < 1/255
// is skipped; a key is included iff T (1 - alpha) >= 1e-4, and the first key
// that would cross that threshold ends the pixel.
//
// What bounds it on an H100: per block, its densest warp. A walked (warp,
// key) slot costs ~30 warp instructions up to the 1/255 test (the geometry
// and an exp2) and ~20 more to blend; one warp walks the keys in order per 2
// pixel rows, and the block waits for its slowest warp at each batch's
// barrier. Each key is read from device memory once (40 B), so bytes are
// small beside the instructions.
//
// Design: one block of 256 threads per tile, one thread per pixel, the
// running sums in registers, 256 keys at a time in shared memory (every
// thread reads the same key at once, a broadcast):
// - the batches are double-buffered: the next 256 keys are copied with
//   cp.async (8-byte pieces, coalesced) while the current ones are blended,
//   one barrier per batch, and the block stops at a batch boundary once
//   every pixel is done (__syncthreads_count);
// - each 40-byte row is repacked to 48 bytes in shared memory,
//   [x y l11 l21 | l22 r z lopa | g b - -] (its five 8-byte pieces moved
//   whole), so the alpha reads two float4 and the blend one more;
// - while a batch's copies are in flight, thread i evaluates key i's
//   gauss_common.cuh:warp_mask(); a warp whose bit is clear skips the key
//   for one shared byte, before any geometry;
// - a thread stops once its pixel is done, and a warp once all its lanes
//   are.
// On the full-width 3DGS stream the mask skips a third of the walked slots
// but costs K2 more than that saves (PERF.md): the skipped slots lie mostly
// in sparse warps, and a block's time is its densest warp's.
// Only loads and skips differ from the plain version: every included key
// is blended by the same -fmad=false arithmetic in the same order, so the
// outputs are bit-identical to composite_plain's on the card. The TPU
// kernel evaluated chunks of 128 keys as [256,128] vector blocks with the
// transmittance as a log-space triangular matmul scan, because the TPU has
// no per-pixel scalar threads; here the transmittance is a plain running
// product in a register.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gauss_common.cuh"

namespace {

using namespace gauss;

constexpr int kQuads = 3;  // float4 per shared row

__device__ __forceinline__ void copy_async8(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// Copies the n <= 256 stream rows at src (8-byte aligned: rows are 40 B)
// into buf as shared rows, one cp.async per 8-byte piece, consecutive
// threads on consecutive pieces, committed as one group; then, while they
// are in flight, thread i < n writes row i's warp_mask into mask. Piece p
// of a row lands at float (0x68420 >> 4p) & 15 of its shared row: (x y) 0,
// (l11 l21) 2, (l22 r) 4, (g b) 8, (z lopa) 6.
__device__ __forceinline__ void stage_rows(float4* buf, unsigned char* mask,
                                           const float* __restrict__ src, int n, int tid,
                                           int x0, int y0) {
  float* dst = reinterpret_cast<float*>(buf);
  for (int i = tid; i < 5 * n; i += kPix) {
    const int row = i / 5, piece = i - 5 * row;
    copy_async8(dst + 4 * kQuads * row + ((0x68420 >> (4 * piece)) & 15), src + 2 * i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < n) mask[tid] = (unsigned char)warp_mask(gauss::geo_of(src + kRows * tid), x0, y0);
}

// the geometry of a shared row from its first two quads
__device__ __forceinline__ Geo geo_of(float4 a, float4 b) {
  return Geo{a.x, a.y, a.z, a.w, b.x, b.w};
}

__global__ void __launch_bounds__(kPix) composite_kernel(
    const float* __restrict__ data, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const float* __restrict__ bg, int tiles_x,
    float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_alpha, int* __restrict__ out_ncontrib,
    float* __restrict__ out_tfinal) {
  __shared__ float4 s_keys[2][kPix * kQuads];
  __shared__ unsigned char s_mask[2][kPix];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned warp_bit = 1u << (tid >> 5);
  const int x0 = (t % tiles_x) * kTile, y0 = (t / tiles_x) * kTile;
  const float px = (float)(x0 + tid % kTile);
  const float py = (float)(y0 + tid / kTile);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const float* src = data + (size_t)start * kRows;

  float trans = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  int last = 0;
  bool done = false;
  if (count > 0) stage_rows(s_keys[0], s_mask[0], src, min(kPix, count), tid, x0, y0);
  for (int b = 0, buf = 0; b < count; b += kPix, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // one barrier per batch: this thread's copies have landed, everyone's
    // copies and masks are visible, every warp is done with the other
    // buffer, and the exit is block-uniform
    if (__syncthreads_count(done) == kPix) break;
    if (b + kPix < count) {
      stage_rows(s_keys[buf ^ 1], s_mask[buf ^ 1], src + (size_t)(b + kPix) * kRows,
                 min(kPix, count - b - kPix), tid, x0, y0);
    }
    const float4* keys = s_keys[buf];
    const int n_batch = min(kPix, count - b);
    const unsigned char* mask = s_mask[buf];
    for (int j = 0; j < n_batch && !done; ++j) {
      if (!(mask[j] & warp_bit)) continue;  // warp-uniform
      const float4 ka = keys[kQuads * j];
      const float4 kb = keys[kQuads * j + 1];
      const float alpha = alpha_of(geo_of(ka, kb), px, py).alpha;
      if (alpha < kAlphaMin) continue;
      const float test_t = trans * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float4 kc = keys[kQuads * j + 2];
      const float w = alpha * trans;
      c0 += w * kb.y;
      c1 += w * kc.x;
      c2 += w * kc.y;
      dep += w * kb.z;
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
