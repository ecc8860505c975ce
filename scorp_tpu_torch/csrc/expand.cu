// Kernel K1: key expansion with the exact alpha>=1/255 ellipse-vs-tile cull.
//
// Replaces the TPU kernel scorp_tpu/ops/raster/pallas_expand.py:80
// (_expand_kernel, entered through expand_sorted_keys). Plain PyTorch
// version: scorp_tpu_torch/ops/raster/expand.py:expand_keys_plain.
//
// Input, depth-sorted per gaussian g < n: starts[g] (exclusive prefix sum
// of the rect tile counts, clamped to k_cap), rect[g] = (x0, y0, x1, y1)
// and, when culling, geo[g] = (cx, cy, A, B, C, t2) and optionally a second
// ellipse geo2[g] (the surfel path passes its UV-disc conic and low-pass
// circle; the 3DGS path passes null): a key is kept iff either ellipse
// admits its tile. limit[0] = min(total, k_cap). Output per key slot
// k < k_cap: the int64 sort key
// (tile << bits_g) | g, or the sentinel num_tiles << bits_g for a culled key
// or k >= limit; and kept[0] += the number of live keys.
//
// What bounds it on an H100: bytes. It writes 8 B per key slot (k_cap =
// 2^22 at full width: 32 MiB) and reads the per-gaussian table once
// (44 B per gaussian), while the arithmetic per key is a ~18-step binary
// search over L2-resident `starts` and ~60 flops of edge tests.
//
// Design: one thread per key slot, so the writes are fully coalesced and
// no thread waits on another. The TPU kernel gathered per-key attributes
// with one-hot bf16 matmuls over 640-gaussian windows because the TPU has
// no per-lane gather; here each thread binary-searches `starts` for its
// gaussian and reads that gaussian's rect and f32 geometry directly (reads
// of neighbouring threads hit the same gaussians, so they coalesce in
// L1/L2). The cull runs on exact f32 geometry, no bf16 or fixed point.
// One atomicAdd per block (after __syncthreads_count) counts kept keys.
// Sizes are ints: k_cap < 2^31 and every start is clamped to k_cap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = 256;

struct QPair {
  float q, qa;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ QPair min_pair(QPair p1, QPair p2) {
  return (p1.q <= p2.q) ? p1 : p2;
}

// q(d) = A dx^2 + 2B dx dy + C dy^2 minimized along the vertical edge
// dx = e (dy clamped to the box), with its cancellation magnitude qa.
__device__ __forceinline__ QPair q_edge_x(float e, float a, float b, float c,
                                          float sa, float sc, float dylo, float dyhi) {
  const float dy = clampf(-b * e / sc, dylo, dyhi);
  const float cross = b * e * dy;
  QPair r;
  r.q = a * e * e + 2.0f * cross + c * dy * dy;
  r.qa = sa * e * e + 2.0f * fabsf(cross) + sc * dy * dy;
  return r;
}

// ... and along the horizontal edge dy = f.
__device__ __forceinline__ QPair q_edge_y(float f, float a, float b, float c,
                                          float sa, float sc, float dxlo, float dxhi) {
  const float dx = clampf(-b * f / sa, dxlo, dxhi);
  const float cross = b * f * dx;
  QPair r;
  r.q = c * f * f + 2.0f * cross + a * dx * dx;
  r.qa = sc * f * f + 2.0f * fabsf(cross) + sa * dx * dx;
  return r;
}

// Does the alpha>=1/255 ellipse of this gaussian reach tile (tx, ty)?
// Conservative: the tolerance covers f32 rounding only (see
// expand.py:cull_keep_tight for the same rule in PyTorch).
__device__ bool keep_tile(const float* __restrict__ geo, int tx, int ty) {
  const float cx = geo[0], cy = geo[1];
  const float a = geo[2], b = geo[3], c = geo[4], t2 = geo[5];
  const float fx = (float)(tx * kTile), fy = (float)(ty * kTile);
  const float dxlo = fx - cx, dxhi = fx + (float)(kTile - 1) - cx;
  const float dylo = fy - cy, dyhi = fy + (float)(kTile - 1) - cy;
  const bool inside = dxlo <= 0.0f && 0.0f <= dxhi && dylo <= 0.0f && 0.0f <= dyhi;
  const float sa = fmaxf(a, 1e-12f), sc = fmaxf(c, 1e-12f);
  const QPair m = min_pair(
      min_pair(q_edge_x(dxlo, a, b, c, sa, sc, dylo, dyhi),
               q_edge_x(dxhi, a, b, c, sa, sc, dylo, dyhi)),
      min_pair(q_edge_y(dylo, a, b, c, sa, sc, dxlo, dxhi),
               q_edge_y(dyhi, a, b, c, sa, sc, dxlo, dxhi)));
  const float q_min = inside ? 0.0f : m.q;
  const float qabs = inside ? 0.0f : m.qa;
  const bool pd = a > 0.0f && c > 0.0f && a * c - b * b > 0.0f;
  return !pd || q_min <= t2 + 4e-5f * qabs + 2e-3f;
}

__global__ void __launch_bounds__(kBlock) expand_keys_kernel(
    const int* __restrict__ starts, const int* __restrict__ limit,
    const int4* __restrict__ rect, const float* __restrict__ geo,
    const float* __restrict__ geo2, int n, int k_cap, int tiles_x, int num_tiles, int bits_g,
    long long* __restrict__ keys, int* __restrict__ kept) {
  const int k = blockIdx.x * kBlock + threadIdx.x;
  bool live = false;
  if (k < k_cap) {
    long long key = (long long)num_tiles << bits_g;
    if (k < *limit) {
      // last gaussian g with starts[g] <= k; starts is nondecreasing and
      // starts[0] = 0, and because k < total the rect of g is non-empty
      int lo = 0, hi = n - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(starts + mid) <= k) lo = mid; else hi = mid - 1;
      }
      const int g = lo;
      const int4 r = rect[g];
      const int span = max(r.z - r.x, 1);
      const int local = k - __ldg(starts + g);
      const int qy = local / span;
      const int tx = r.x + (local - qy * span);
      const int ty = r.y + qy;
      live = geo == nullptr || keep_tile(geo + 6 * (size_t)g, tx, ty) ||
             (geo2 != nullptr && keep_tile(geo2 + 6 * (size_t)g, tx, ty));
      if (live) key = ((long long)(ty * tiles_x + tx) << bits_g) | (long long)g;
    }
    keys[k] = key;
  }
  const int block_kept = __syncthreads_count(live);
  if (threadIdx.x == 0 && block_kept > 0) atomicAdd(kept, block_kept);
}

}  // namespace

extern "C" int scorp_expand_keys(const void* starts, const void* limit, const void* rect,
                                 const void* geo, const void* geo2, int n, int k_cap,
                                 int tiles_x, int num_tiles, int bits_g, void* keys,
                                 void* kept, void* stream) {
  const int grid = (k_cap + kBlock - 1) / kBlock;
  expand_keys_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)limit, (const int4*)rect, (const float*)geo,
      (const float*)geo2, n, k_cap, tiles_x, num_tiles, bits_g, (long long*)keys, (int*)kept);
  return (int)cudaGetLastError();
}
