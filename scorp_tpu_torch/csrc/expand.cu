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
// k < k_cap: the packed sort key (tile << bits_g) | g, or the sentinel
// num_tiles << bits_g for a culled key or k >= limit; and kept[0] += the
// number of live keys. The key is 32 bits when (num_tiles + 1) << bits_g
// fits in a positive int32 (the JAX package's `packable` rule), else 64.
//
// What bounds it on an H100: bytes. It writes 4 B per key slot (k_cap =
// 2^22 at full width: 16 MiB; 8 B with 64-bit keys) and reads the
// per-gaussian table once (44 B per gaussian, 68 with a second ellipse);
// ~60 flops of edge tests per live slot are far below the card's rate.
//
// Design: finding a slot's gaussian is the latency to hide. One thread per
// slot with a binary search of `starts` in device memory costs ~18
// dependent loads per slot, though neighbouring slots nearly always share
// their gaussian. Here a block owns 1024 consecutive slots, 4 contiguous
// ones per thread, and searches once for all of them (a load-balanced
// search): two warps find the block's first and last gaussian g_lo and g_hi
// by a 32-way search of `starts` (one load per lane and round, 4 dependent
// rounds for 250k gaussians); the block marks in shared memory the slot at
// which each gaussian of (g_lo, g_hi] starts (coalesced reads of
// starts[g_lo+1..g_hi], atomicMax so that a gaussian without slots yields
// to the next one); an inclusive max-scan of the marks, floored at g_lo,
// gives every slot its gaussian. The marks need no bound on g_hi - g_lo: a
// block whose gaussians all span several blocks has g_lo == g_hi and no
// marks. A thread reads its gaussian's rect, start and geometry once for
// its run of slots (neighbouring threads read the same rows, so the loads
// coalesce in L1) and stores its 4 keys as one 16-byte vector (two for
// 64-bit keys). Slots at or past limit get the sentinel alone, and a block
// wholly past limit only stores sentinels. The cull runs on exact f32
// geometry, no bf16 or fixed point, with the same operations as the plain
// version (built with -fmad=false), so the keys are bit-identical to it.
// kept: a warp sum of the threads' live counts, one shared add per warp
// and one atomicAdd per block. Sizes are ints: the wrapper keeps
// k_cap <= 2^30, and every start is clamped to k_cap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // contiguous slots per thread, a multiple of 4
constexpr int kBlockSlots = kThreads * kPerThread;   // expand.py:BLOCK_SLOTS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Does the alpha>=1/255 ellipse geo = (cx, cy, A, B, C, t2) reach tile
// (tx, ty)? Conservative: the tolerance covers f32 rounding only (see
// expand.py:cull_keep_tight for the same rule in PyTorch).
__device__ __forceinline__ bool keep_tile(const float (&geo)[6], int tx, int ty) {
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

// The last g in [0, n) with starts[g] <= k (starts[0] = 0 <= k), by one
// warp: each round lane i probes lo + (i + 1) * (hi - lo) / 32 (lane 31
// probes hi); the probes' results fall from true to false, so their count
// c brackets the answer between probe c - 1 (or lo) and probe c. Every
// lane returns it. Mirrored by expand.py:warp_search_plain.
__device__ int warp_search(const int* __restrict__ starts, int n, int k, int lane) {
  int lo = 0, hi = n - 1;  // starts[lo] <= k, and the answer lies in [lo, hi]
  while (lo < hi) {
    const int p = lo + (int)(((long long)(lane + 1) * (hi - lo)) >> 5);
    const int c = __popc(__ballot_sync(kFull, __ldg(starts + p) <= k));
    if (c == 32) return hi;
    const int p_hi = __shfl_sync(kFull, p, c);
    const int p_lo = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    if (c > 0) lo = p_lo;
    hi = p_hi - 1;
  }
  return lo;
}

// A thread's keys, as 16-byte vectors where all of them lie below k_cap.
template <typename Key>
__device__ __forceinline__ void store_keys(Key* __restrict__ keys, int first, int k_cap,
                                           const Key (&v)[kPerThread]) {
  if (first + kPerThread <= k_cap) {
#pragma unroll
    for (int j = 0; j < kPerThread; j += 4) {
      if constexpr (sizeof(Key) == 4) {
        *reinterpret_cast<uint4*>(keys + first + j) =
            make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else {
        reinterpret_cast<ulonglong2*>(keys + first + j)[0] = make_ulonglong2(v[j], v[j + 1]);
        reinterpret_cast<ulonglong2*>(keys + first + j)[1] = make_ulonglong2(v[j + 2], v[j + 3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (first + j < k_cap) keys[first + j] = v[j];
  }
}

template <typename Key>
__global__ void __launch_bounds__(kThreads) expand_keys_kernel(
    const int* __restrict__ starts, const int* __restrict__ limit,
    const int4* __restrict__ rect, const float* __restrict__ geo,
    const float* __restrict__ geo2, int n, int k_cap, int tiles_x, int num_tiles, int bits_g,
    Key* __restrict__ keys, int* __restrict__ kept) {
  __shared__ __align__(16) int s_mark[kBlockSlots];
  __shared__ int s_range[2];
  __shared__ int s_warp_max[kWarps];
  __shared__ int s_kept;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kBlockSlots;
  const int first = b0 + tid * kPerThread;
  const Key sentinel = (Key)num_tiles << bits_g;
  Key out[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) out[j] = sentinel;

  const int lim = __ldg(limit);
  if (b0 >= lim) {  // the whole block is past the live keys
    store_keys(keys, first, k_cap, out);
    return;
  }
  const int e = min(lim, b0 + kBlockSlots);  // live slots of the block: [b0, e)

  if (warp < 2) {
    const int g = warp_search(starts, n, warp == 0 ? b0 : e - 1, lane);
    if (lane == 0) s_range[warp] = g;
  }
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q)
    reinterpret_cast<int4*>(s_mark)[tid * (kPerThread / 4) + q] = make_int4(0, 0, 0, 0);
  if (tid == 0) s_kept = 0;
  __syncthreads();
  const int g_lo = s_range[0], g_hi = s_range[1];
  // every g in (g_lo, g_hi] starts inside (b0, e): mark its first slot
  for (int g = g_lo + 1 + tid; g <= g_hi; g += kThreads)
    atomicMax(s_mark + (__ldg(starts + g) - b0), g);
  __syncthreads();

  // the slot's gaussian: the inclusive max-scan of the marks, floored at
  // g_lo. Thread tid holds the marks of its own slots.
  int own[kPerThread];
  int run = g_lo;
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int4 m = reinterpret_cast<const int4*>(s_mark)[tid * (kPerThread / 4) + q];
    own[4 * q] = run = max(run, m.x);
    own[4 * q + 1] = run = max(run, m.y);
    own[4 * q + 2] = run = max(run, m.z);
    own[4 * q + 3] = run = max(run, m.w);
  }
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, v);
  }
  if (lane == 31) s_warp_max[warp] = incl;
  int carry = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) carry = g_lo;
  __syncthreads();
  for (int w = 0; w < warp; ++w) carry = max(carry, s_warp_max[w]);

  int cur = -1, x0 = 0, y0 = 0, span = 1, start = 0, n_live = 0;
  float ga[6] = {}, gb[6] = {};
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = first + j;
    if (k >= e) continue;
    const int g = max(own[j], carry);
    if (g != cur) {  // a new gaussian for this thread: read its row once
      cur = g;
      const int4 r = __ldg(rect + g);
      x0 = r.x;
      y0 = r.y;
      span = max(r.z - r.x, 1);
      start = __ldg(starts + g);
      if (geo != nullptr) {
#pragma unroll
        for (int i = 0; i < 6; ++i) ga[i] = __ldg(geo + 6 * (size_t)g + i);
      }
      if (geo2 != nullptr) {
#pragma unroll
        for (int i = 0; i < 6; ++i) gb[i] = __ldg(geo2 + 6 * (size_t)g + i);
      }
    }
    const int local = k - start;
    const int qy = local / span;
    const int tx = x0 + (local - qy * span);
    const int ty = y0 + qy;
    const bool live = geo == nullptr || keep_tile(ga, tx, ty) ||
                      (geo2 != nullptr && keep_tile(gb, tx, ty));
    if (live) {
      out[j] = ((Key)(ty * tiles_x + tx) << bits_g) | (Key)g;
      ++n_live;
    }
  }
  store_keys(keys, first, k_cap, out);

  const int warp_live = __reduce_add_sync(kFull, n_live);
  if (lane == 0 && warp_live > 0) atomicAdd(&s_kept, warp_live);
  __syncthreads();
  if (tid == 0 && s_kept > 0) atomicAdd(kept, s_kept);
}

}  // namespace

extern "C" int scorp_expand_keys(const void* starts, const void* limit, const void* rect,
                                 const void* geo, const void* geo2, int n, int k_cap,
                                 int tiles_x, int num_tiles, int bits_g, int wide, void* keys,
                                 void* kept, void* stream) {
  const int grid = (k_cap + kBlockSlots - 1) / kBlockSlots;
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide) {
    expand_keys_kernel<unsigned long long><<<grid, kThreads, 0, s>>>(
        (const int*)starts, (const int*)limit, (const int4*)rect, (const float*)geo,
        (const float*)geo2, n, k_cap, tiles_x, num_tiles, bits_g,
        (unsigned long long*)keys, (int*)kept);
  } else {
    expand_keys_kernel<unsigned int><<<grid, kThreads, 0, s>>>(
        (const int*)starts, (const int*)limit, (const int4*)rect, (const float*)geo,
        (const float*)geo2, n, k_cap, tiles_x, num_tiles, bits_g, (unsigned int*)keys,
        (int*)kept);
  }
  return (int)cudaGetLastError();
}
