// Kernel M: level-0 marching cubes of a dense TSDF grid on the card, the mesh
// of scorp_tpu_torch/pipeline/marching_cubes.py:marching_cubes bit for bit
// (the same vertices in the same order, the same faces, the same colours).
//
// Replaces no TPU kernel: the JAX package triangulates on the host with
// numpy (scorp_tpu/pipeline/marching_cubes.py), over [cells, 8] float64
// corner arrays that at the 2DGS reference code's unbounded resolution
// (1024^3) take 68.5 GB. The wrapper: scorp_tpu_torch/ops/marching_cubes.py
// (it uploads the case tables TRI_TABLE and LOOP_MASK from the Python
// module, scans the row counts and reads the totals);
// pipeline/mesh.py:TsdfVolume.triangulate calls it on the card.
//
// Grid: NX x NY x NZ corners (the voxels of the TSDF grid), corner (x, y, z)
// at flat index (x NY + y) NZ + z; tsdf [N], weight [N], colors [N][3], f32.
// A corner is observed when weight > 0 and inside when !(tsdf > 0). Cell
// (x, y, z), x < NX - 1 and so on, spans the corners (x + dx, y + dy,
// z + dz), corner k = dx + 2 dy + 4 dz; its case has bit k set where corner
// k is inside; it is active when its 8 corners are observed and its case is
// neither 0 nor 255.
//
// The mesh, in the host function's order:
// - an edge vertex on every crossed edge held by at least one active cell
//   (a crossed edge of an observed cell makes that cell active), numbered
//   in ascending key ((gx NY + gy) NZ + gz) 3 + axis of the edge's base
//   corner: by corner row (gx, gy), then gz, then the axis. t = clip(v0 /
//   (v0 - v1), 0, 1), or 0.5 where |v0 - v1| < 1e-30, in float64 from the
//   f32 values; the position adds t to the base corner's axis coordinate,
//   the colour is c0 (1 - t) + c1 t in float64;
// - a centroid vertex for each loop longer than 3 (LOOP_MASK), after every
//   edge vertex, in active-cell order (C order over cells) and then loop
//   order: the sum over the 12 edges of mask x edge position (and colour)
//   over the loop's length, as numpy's reduction adds them (from +0, edge by
//   edge, so only the loop's edges change it);
// - faces in active-cell order, then TRI_TABLE's order; local id e < 12 is
//   edge e's vertex, 12 + l loop l's centroid.
// Vertices then go to world coordinates in float64: q = (p + 0.5) voxel +
// origin per axis, and for a contracted grid uncontract(q) x scale +
// centre, |q| = sqrt((x^2 + y^2) + z^2) (numpy's order for np.linalg.norm
// over three elements), clipped to [1e-9, 2 - 1e-6]. Built with -fmad=false:
// every product and sum rounds as numpy's does; float64 division and sqrt
// are correctly rounded on the card as in numpy.
//
// What bounds it: the weight of every corner, 4 B each (4.29 GB at 1024^3,
// 1.28 ms at 3.35 TB/s): nothing marks unobserved voxels, so every weight
// is read once. The rest is small at room scale: the tsdf of corners of
// observed cells, the colours at edge ends and the mesh written.
//
// Design: one pass reads the whole grid at the card's bandwidth, the later
// passes visit only compacted lists of 32-corner chunks (a word of a row
// along z) near the surface.
// 1. mc_cells_count, a persistent grid of tiles: a tile owns kTX corner
//    planes x kTY corner rows x kTZ corners along z and stages in shared
//    memory one byte a corner (observed; inside, where read) over one more
//    plane, row and corner on each side. Weights arrive as 16-byte loads
//    where a row's address allows it, four row pieces in flight a warp; the
//    corners beside the tile along z are read only where the tile has an
//    observed corner (else it owns no cell or edge to find). Tiles run z
//    fastest, then x, so the tiles in flight read whole rows and share
//    their border planes through L2. From the bytes, four corners a lane at
//    a time: the all-observed cells, then the tsdf of corners of those
//    cells only, then each cell's case and each corner's edge vertices (a
//    crossed edge with an all-observed cell around it). It writes each
//    chunk's word (cw: its active bits and its vertex, centroid and face
//    counts; a tile's row writes a whole 32-byte sector) and adds each row's
//    five counts (vertices, chunks with vertices, centroids, faces, chunks
//    with active cells) and the chunks with either to zeroed counters. Of
//    the case tables only ntri and ncent are staged, once a block.
//    (The wrapper scans the row counts as one flat scan and reads the
//    totals: the call's one synchronisation.)
// 2. mc_verts<false>, a warp for 32 rows: from the scanned row counts and
//    the chunks' counts, lists in C order the chunks with vertices (with
//    each one's first vertex; vslot maps a chunk to its entry) and the
//    chunks with active cells (with their first centroid and face).
// 3. mc_verts<true>, a warp a listed vertex chunk: an edge of base corner
//    (x, y, z) is held when one of its (up to 4) cells is active in cw;
//    writes each vertex at its chunk's first plus its rank (ballots over
//    the chunk, then the axis) and keeps the three axis ballots.
// 4. mc_cells_emit, a persistent grid of warps over the listed cell chunks,
//    the case tables staged once a block, a lane a cell: centroid and face
//    counts scanned across the warp (a centroid sums only its loop's
//    edges); a face's edge vertex is its corner chunk's first vertex plus a
//    popcount of the chunk's ballots below it, the (up to 8) corner chunks
//    the warp's cells use read once into shared memory through vslot.
// No array of the grid's size beyond the grid: per 32-corner chunk 8 bytes
// of active bits and counts and a 4-byte list slot (~400 MB at 1024^3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTris = 8;  // TRI_TABLE's triangles a case (the wrapper checks)
constexpr int kLoops = 4;    // MAX_LOOPS
// the wrapper's int32 upload: TRI_TABLE [256][kMaxTris][3] (-1 past the
// case's triangles), LOOP_MASK as 12-bit edge masks [256][kLoops] (0 for a
// loop of 3 or none), EDGE_BASE [12]
constexpr int kTriInts = 256 * kMaxTris * 3;
constexpr int kLoopInts = 256 * kLoops;

// the count pass's tile (ops/marching_cubes.py TILE): corner planes, rows
// and corners along z it owns, 4 along z a lane
constexpr int kTX = 8;
constexpr int kTY = 14;
constexpr int kTZ = 128;
constexpr int kPl = kTX + 2;  // corner planes staged: pa - 1 .. pa + kTX
constexpr int kRw = kTY + 2;  // corner rows staged: y0 - 1 .. y0 + kTY
constexpr int kRow = kTZ + 8;  // bytes a staged row: index 4 + m holds z0 + m, 3 holds z0 - 1

// the row counters, counts[k R + row] (R = NX NY), then the chunks with a
// vertex or an active cell at counts[kCounts R]
enum { kVerts, kVertChunks, kCents, kFaces, kCellChunks, kCounts };

struct Dims {
  int nx, ny, nz;  // corners a side
  int words;       // 32-corner chunks a row: ceil(nz / 32)
};

struct Xform {
  double origin[3];
  double voxel;
  int contract;  // 1: uncontract, times scale, plus centre
  double scale;
  double centre[3];
};

__device__ __forceinline__ int64_t corner(const Dims& d, int x, int y, int z) {
  return ((int64_t)x * d.ny + y) * d.nz + z;
}

// ------------------------------------------------------------ count pass

struct alignas(16) CountSmem {
  uint8_t corner[kPl][kRw][kRow];      // bit 0: observed; bit 1: inside (read where needed)
  uint8_t cell[kPl - 1][kRw - 1][kRow];  // all-observed cells (x, y, z) with corner (x, y, z) here
  uint8_t ntri[256];
  uint8_t ncent[256];
};

__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int i) {
  return *reinterpret_cast<const uint32_t*>(row + i);
}

// f32 values of a row at z .. z + 3 (0 at and past nz): one 16-byte load
// where the address allows it
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int z, int nz) {
  const float* p = row + z;
  if (z + 3 < nz && (reinterpret_cast<uintptr_t>(p) & 15u) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (z < nz) v.x = __ldg(p);
  if (z + 1 < nz) v.y = __ldg(p + 1);
  if (z + 2 < nz) v.z = __ldg(p + 2);
  if (z + 3 < nz) v.w = __ldg(p + 3);
  return v;
}

// a byte 1 where v > 0, one byte a value
__device__ __forceinline__ uint32_t positive(float4 v) {
  return (uint32_t)(v.x > 0.f) | (uint32_t)(v.y > 0.f) << 8 | (uint32_t)(v.z > 0.f) << 16 |
         (uint32_t)(v.w > 0.f) << 24;
}

struct CountArgs {
  const float* tsdf;
  const float* weight;
  Dims d;
  const int* tables;
  uint2* cw;        // [R][words]: a chunk's active bits (x) and counts (y)
  int* counts;      // [kCounts][R] + 1, zeroed
  int tx, ty, tz;   // tiles along x, y, z
};

// the tile's chunks of row (p, y): none active, nothing counted
__device__ __forceinline__ void zero_chunks(const CountArgs& a, int64_t row, int z0, int lane) {
  const int w = z0 / 32 + lane;
  if (lane < kTZ / 32 && w < a.d.words) a.cw[row * a.d.words + w] = make_uint2(0u, 0u);
}

// every owned row's chunks of the tile: none active, nothing counted; a
// warp's store covers 8 rows (lane 4 r + j: row r's chunk j)
__device__ void zero_tile(const CountArgs& a, int pa, int y0, int z0, int warp, int lane) {
  const int w = z0 / 32 + (lane & 3);
  for (int k = warp * 8 + (lane >> 2); k < kTX * kTY; k += kWarps * 8) {
    const int p = pa + k / kTY, y = y0 + k % kTY;
    if (p < a.d.nx && y < a.d.ny && w < a.d.words)
      a.cw[((int64_t)p * a.d.ny + y) * a.d.words + w] = make_uint2(0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads, 4) mc_cells_count(CountArgs a) {
  __shared__ CountSmem s;
  for (int c = threadIdx.x; c < 256; c += kThreads) {
    int n = 0;
    while (n < kMaxTris && a.tables[(c * kMaxTris + n) * 3] >= 0) ++n;
    int m = 0;
    for (int l = 0; l < kLoops; ++l) m += a.tables[kTriInts + c * kLoops + l] != 0;
    s.ntri[c] = (uint8_t)n;
    s.ncent[c] = (uint8_t)m;
  }
  const Dims d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int idx = 4 + 4 * lane;  // a lane's four corners z0 + 4 lane .. + 3
  int touched = 0;
  const int64_t tiles = (int64_t)a.tx * a.ty * a.tz;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    // z fastest, then x, then y: the tiles in flight together read whole
    // rows of neighbouring planes and share their border planes through L2
    const int z0 = (int)(t % a.tz) * kTZ, pa = (int)(t / a.tz % a.tx) * kTX,
              y0 = (int)(t / ((int64_t)a.tz * a.tx)) * kTY;
    // 1. observed bytes of the staged corners z0 .. z0 + kTZ - 1, four row
    //    pieces in flight a warp
    uint32_t seen = 0u;
    constexpr int kPieces = kPl * kRw / kWarps;
    static_assert(kPl * kRw % kWarps == 0 && kPieces % 4 == 0, "staged rows split evenly");
#pragma unroll
    for (int b = 0; b < kPieces; b += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = warp + (b + u) * kWarps, p = pa - 1 + k / kRw, y = y0 - 1 + k % kRw;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p >= 0 && p < d.nx && y >= 0 && y < d.ny)
          v[u] = load4(a.weight + corner(d, p, y, 0), z0 + 4 * lane, d.nz);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = warp + (b + u) * kWarps;
        const uint32_t bits = positive(v[u]);
        *reinterpret_cast<uint32_t*>(s.corner[k / kRw][k % kRw] + idx) = bits;
        seen |= bits;
      }
    }
    // none observed: every owned cell and edge has an unobserved corner
    if (!__syncthreads_or(seen != 0u)) {
      zero_tile(a, pa, y0, z0, warp, lane);
      continue;
    }
    // 1b. the staged rows' corners z0 - 1 and z0 + kTZ, two lanes a row
    for (int k = warp * 16 + (lane >> 1); k < kPl * kRw; k += kWarps * 16) {
      const int p = pa - 1 + k / kRw, y = y0 - 1 + k % kRw, z = lane & 1 ? z0 + kTZ : z0 - 1;
      float wv = 0.f;
      if (p >= 0 && p < d.nx && y >= 0 && y < d.ny && z >= 0 && z < d.nz)
        wv = __ldg(a.weight + corner(d, p, y, z));
      s.corner[k / kRw][k % kRw][lane & 1 ? 4 + kTZ : 3] = wv > 0.f;
    }
    __syncthreads();
    // 2. all-observed cells of cell planes pa - 1 .. pa + kTX - 1, rows
    //    y0 - 1 .. y0 + kTY - 1, z0 - 1 .. z0 + kTZ - 1
    uint32_t any = 0u;
    for (int k = warp; k < (kPl - 1) * (kRw - 1); k += kWarps) {
      const int cp = k / (kRw - 1), r = k % (kRw - 1);
      const uint8_t *c00 = s.corner[cp][r], *c01 = s.corner[cp][r + 1],
                    *c10 = s.corner[cp + 1][r], *c11 = s.corner[cp + 1][r + 1];
      const uint32_t col = word_at(c00, idx) & word_at(c01, idx) & word_at(c10, idx) &
                           word_at(c11, idx) & 0x01010101u;  // corners z: all four rows observed
      const uint32_t nxt = c00[idx + 4] & c01[idx + 4] & c10[idx + 4] & c11[idx + 4] & 1u;
      const uint32_t obs = col & ((col >> 8) | (nxt << 24));
      uint8_t* orow = s.cell[cp][r];
      *reinterpret_cast<uint32_t*>(orow + idx) = obs;
      any |= obs;
      if (lane == 0) {
        orow[3] = c00[3] & c01[3] & c10[3] & c11[3] & col & 1u;
        any |= orow[3];
      }
      if (lane == 31) orow[4 + kTZ] = 0;  // cell z0 + kTZ is the next tile's
    }
    if (!__syncthreads_or(any != 0u)) {
      zero_tile(a, pa, y0, z0, warp, lane);
      continue;
    }
    // 3. inside bits of the corners of all-observed cells: planes pa ..
    //    pa + kTX, rows y0 .. y0 + kTY, z0 .. z0 + kTZ (the tsdf is read there
    //    only), four row pieces in flight a warp
    constexpr int kNeed = (kPl - 1) * (kRw - 1);
    for (int b = warp; b < kNeed; b += 4 * kWarps) {
      float4 v[4];
      float hi[4];
      uint32_t need[4], need_hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = b + u * kWarps;
        need[u] = need_hi[u] = 0u;
        v[u] = make_float4(1.f, 1.f, 1.f, 1.f);
        hi[u] = 1.f;
        if (k >= kNeed) continue;
        const int pl = 1 + k / (kRw - 1), r = 1 + k % (kRw - 1);
        uint32_t n = 0u, np = 0u;  // cells z and z - 1 around corner z
        for (int cp = pl - 1; cp <= pl && cp < kPl - 1; ++cp)
          for (int cr = r - 1; cr <= r && cr < kRw - 1; ++cr) {
            n |= word_at(s.cell[cp][cr], idx);
            np |= s.cell[cp][cr][idx - 1];
          }
        need[u] = n | (n << 8) | np;
        need_hi[u] = lane == 31 ? n >> 24 : 0u;  // corner z0 + kTZ: cell z0 + kTZ - 1
        if (need[u] | need_hi[u]) {
          const float* tr = a.tsdf + corner(d, pa - 1 + pl, y0 - 1 + r, 0);
          if (need[u]) v[u] = load4(tr, z0 + 4 * lane, d.nz);
          if (need_hi[u]) hi[u] = __ldg(tr + z0 + kTZ);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = b + u * kWarps;
        if (k >= kNeed || !(need[u] | need_hi[u])) continue;
        uint8_t* row = s.corner[1 + k / (kRw - 1)][1 + k % (kRw - 1)];
        const uint32_t in = (~positive(v[u])) & need[u] & 0x01010101u;
        *reinterpret_cast<uint32_t*>(row + idx) |= in << 1;
        if (need_hi[u] && !(hi[u] > 0.f)) row[4 + kTZ] |= 2u;
      }
    }
    __syncthreads();
    // 4. each owned corner row: its cells' cases and its edge vertices, then
    //    the chunks' bits and counts and the row's counts
    for (int k = warp; k < kTX * kTY; k += kWarps) {
      const int pl = 1 + k / kTY, r = 1 + k % kTY;
      const int p = pa - 1 + pl, y = y0 - 1 + r;
      if (p >= d.nx || y >= d.ny) continue;
      const int64_t row = (int64_t)p * d.ny + y;
      // all-observed cells: o<i><j> of cell plane p - 1 + i, row y - 1 + j, at
      // z and (s) at z - 1
      const uint8_t *o11 = s.cell[pl][r], *o10 = s.cell[pl][r - 1], *o01 = s.cell[pl - 1][r],
                    *o00 = s.cell[pl - 1][r - 1];
      const uint32_t c11 = word_at(o11, idx), c10 = word_at(o10, idx), c01 = word_at(o01, idx),
                     c00 = word_at(o00, idx);
      const uint32_t s11 = (c11 << 8) | o11[idx - 1], s10 = (c10 << 8) | o10[idx - 1],
                     s01 = (c01 << 8) | o01[idx - 1];
      // an edge's cells: axis 0 (p, y - j, z - k), axis 1 (p - i, y, z - k),
      // axis 2 (p - i, y - j, z)
      const uint32_t h0 = c11 | s11 | c10 | s10, h1 = c11 | s11 | c01 | s01,
                     h2 = c11 | c10 | c01 | c00;
      if (__ballot_sync(~0u, (h0 | h1 | h2) != 0u) == 0u) {
        zero_chunks(a, row, z0, lane);
        continue;
      }
      // inside bits i<dx><dy> of corner rows (p + dx, y + dy) at z, z<dx><dy> at z + 1
      const uint8_t *r00 = s.corner[pl][r], *r10 = s.corner[pl + 1][r],
                    *r01 = s.corner[pl][r + 1], *r11 = s.corner[pl + 1][r + 1];
      const uint32_t i00 = (word_at(r00, idx) >> 1) & 0x01010101u,
                     i10 = (word_at(r10, idx) >> 1) & 0x01010101u,
                     i01 = (word_at(r01, idx) >> 1) & 0x01010101u,
                     i11 = (word_at(r11, idx) >> 1) & 0x01010101u;
      const uint32_t z00 = (i00 >> 8) | (uint32_t)((r00[idx + 4] >> 1) & 1) << 24,
                     z10 = (i10 >> 8) | (uint32_t)((r10[idx + 4] >> 1) & 1) << 24,
                     z01 = (i01 >> 8) | (uint32_t)((r01[idx + 4] >> 1) & 1) << 24,
                     z11 = (i11 >> 8) | (uint32_t)((r11[idx + 4] >> 1) & 1) << 24;
      const int nv = __popc(h0 & (i00 ^ i10)) + __popc(h1 & (i00 ^ i01)) +
                     __popc(h2 & (i00 ^ z00));
      // byte k: the case of cell (p, y, z0 + 4 lane + k), corner bit dx + 2 dy + 4 dz
      const uint32_t cases = i00 | i10 << 1 | i01 << 2 | i11 << 3 | z00 << 4 | z10 << 5 |
                             z01 << 6 | z11 << 7;
      const uint32_t act = c11 & __vcmpne4(cases, 0u) & __vcmpne4(cases, 0xffffffffu);
      int nc = 0, nf = 0;
      for (int b = 0; b < 4; ++b)
        if ((act >> (8 * b)) & 1u) {
          const int cs = (cases >> (8 * b)) & 255;
          nc += s.ncent[cs];
          nf += s.ntri[cs];
        }
      // a chunk is 8 lanes: its counts (vertices <= 96, centroids <= 128,
      // faces <= 256) and active bits
      uint32_t sum = (uint32_t)nv | (uint32_t)nc << 10 | (uint32_t)nf << 20;
      uint32_t bits = ((act & 1u) | ((act >> 7) & 2u) | ((act >> 14) & 4u) | ((act >> 21) & 8u))
                      << (4 * (lane & 7));
      for (int o = 1; o < 8; o <<= 1) {
        sum += __shfl_xor_sync(~0u, sum, o);
        bits |= __shfl_xor_sync(~0u, bits, o);
      }
      sum = __shfl_sync(~0u, sum, 8 * (lane & 3));  // lane j < 4: chunk j
      bits = __shfl_sync(~0u, bits, 8 * (lane & 3));
      const int w = z0 / 32 + lane;
      const bool mine = lane < kTZ / 32 && w < d.words;
      const uint32_t cv = sum & 1023u, cc = (sum >> 10) & 1023u, cf = sum >> 20;
      if (mine) a.cw[row * d.words + w] = make_uint2(bits, cv | cc << 8 | cf << 16);
      int n[kCounts + 1] = {0, 0, 0, 0, 0, 0};
      if (mine) {
        n[kVerts] = (int)cv;
        n[kVertChunks] = cv != 0u;
        n[kCents] = (int)cc;
        n[kFaces] = (int)cf;
        n[kCellChunks] = bits != 0u;
        n[kCounts] = cv != 0u || bits != 0u;
      }
      for (int c = 0; c <= kCounts; ++c) {
        n[c] += __shfl_xor_sync(~0u, n[c], 1);
        n[c] += __shfl_xor_sync(~0u, n[c], 2);
      }
      if (lane == 0) {
        const int64_t rows = (int64_t)d.nx * d.ny;
        for (int c = 0; c < kCounts; ++c)
          if (n[c]) atomicAdd(a.counts + c * rows + row, n[c]);
        touched += n[kCounts];
      }
    }
    __syncthreads();
  }
  if (lane == 0 && touched) atomicAdd(a.counts + (int64_t)kCounts * d.nx * d.ny, touched);
}

// ------------------------------------------------------------ later passes

struct Tables {
  int8_t tri[256][kMaxTris][3];
  uint16_t loops[256][kLoops];
  uint8_t ntri[256];
  uint8_t ncent[256];
  int8_t edge_base[12];
};

__device__ void load_tables(const int* __restrict__ g, Tables& s) {
  int8_t* tri = &s.tri[0][0][0];
  uint16_t* loops = &s.loops[0][0];
  for (int i = threadIdx.x; i < kTriInts; i += blockDim.x) tri[i] = (int8_t)g[i];
  for (int i = threadIdx.x; i < kLoopInts; i += blockDim.x) loops[i] = (uint16_t)g[kTriInts + i];
  for (int i = threadIdx.x; i < 12; i += blockDim.x) s.edge_base[i] = (int8_t)g[kTriInts + kLoopInts + i];
  __syncthreads();
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    int n = 0;
    while (n < kMaxTris && s.tri[c][n][0] >= 0) ++n;
    s.ntri[c] = (uint8_t)n;
    int m = 0;
    for (int l = 0; l < kLoops; ++l) m += s.loops[c][l] != 0;
    s.ncent[c] = (uint8_t)m;
  }
  __syncthreads();
}

// t of an edge from its base value v0 to v1, as the host function forms it
__device__ __forceinline__ double edge_t(double v0, double v1) {
  const double den = v0 - v1;
  if (fabs(den) < 1e-30) return 0.5;
  double t = v0 / den;
  t = t > 0.0 ? t : 0.0;  // np.clip: the lower bound, then the upper
  return t < 1.0 ? t : 1.0;
}

// grid coordinates -> world, as marching_cubes' affine map and
// mesh.uncontract (x scale + centre) do it
__device__ void to_world(const Xform& f, const double p[3], double* out) {
  double q[3];
  for (int c = 0; c < 3; ++c) q[c] = (p[c] + 0.5) * f.voxel + f.origin[c];
  if (!f.contract) {
    for (int c = 0; c < 3; ++c) out[c] = q[c];
    return;
  }
  const double n = sqrt((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]);
  double s = n > 1e-9 ? n : 1e-9;
  s = s < 2.0 - 1e-6 ? s : 2.0 - 1e-6;
  const double den = s * (2.0 - s);
  for (int c = 0; c < 3; ++c) {
    const double w = n <= 1.0 ? q[c] : q[c] / den;
    out[c] = w * f.scale + f.centre[c];
  }
}

struct EmitArgs {
  const float* tsdf;
  const float* colors;
  Dims d;
  const int* tables;
  const uint2* cw;  // a chunk's active bits (x) and counts (y)
  const int* counts;
  const int64_t* ends;  // inclusive scan of counts[0 .. kCounts R)
  int64_t nverts, vchunks, cchunks;
  Xform f;
  double* verts;
  double* vcols;
  int64_t* faces;
  // the lists (scratch)
  uint4* vbits;    // [vchunks]: the axis ballots of a vertex chunk
  int* vslot;      // [R][words]: a vertex chunk's entry (written for those only)
  int64_t* vlist;  // [vchunks]: chunk (row words + word)
  int64_t* vbase;  // [vchunks]: its first vertex
  int64_t* clist;  // [cchunks]: chunk with an active cell
  int64_t* cbase;  // [cchunks][2]: its first centroid (after the edge vertices), first face
};

__device__ __forceinline__ int64_t warp_id() {
  return ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int64_t warps_in_grid() {
  return ((int64_t)gridDim.x * blockDim.x) >> 5;
}

// 2: the lists, 32 rows a warp
__device__ void place_chunks(const EmitArgs& a) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)d.nx * d.ny, first = warp_id() * 32;
  if (first >= rows) return;
  const int64_t mine = first + lane;
  const bool listed = mine < rows && (a.counts[kVertChunks * rows + mine] |
                                      a.counts[kCellChunks * rows + mine]) != 0;
  const uint32_t lower = (1u << lane) - 1u;
  for (uint32_t todo = __ballot_sync(~0u, listed); todo; todo &= todo - 1) {
    const int64_t row = first + __ffs(todo) - 1;
    int64_t next[kCounts];  // the row's first vertex, vertex chunk, centroid, face, cell chunk
    for (int c = 0; c < kCounts; ++c)
      next[c] = a.ends[c * rows + row] - a.counts[c * rows + row] -
                (c > 0 ? a.ends[c * rows - 1] : 0);
    for (int w0 = 0; w0 < d.words; w0 += 32) {
      const int w = w0 + lane;
      const int64_t chunk = row * d.words + w;
      uint32_t packed = 0u, bits = 0u;
      if (w < d.words) {
        const uint2 c = a.cw[chunk];
        bits = c.x;
        packed = c.y;
      }
      const int nv = packed & 255u, nc = (packed >> 8) & 255u, nf = packed >> 16;
      int sv = nv, sc = nc, sf = nf;  // inclusive scans across the warp
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(~0u, sv, o), v = __shfl_up_sync(~0u, sc, o),
                  x = __shfl_up_sync(~0u, sf, o);
        if (lane >= o) {
          sv += u;
          sc += v;
          sf += x;
        }
      }
      const uint32_t vb = __ballot_sync(~0u, nv > 0), cb = __ballot_sync(~0u, bits != 0u);
      if (nv > 0) {
        const int64_t i = next[kVertChunks] + __popc(vb & lower);
        a.vlist[i] = chunk;
        a.vbase[i] = next[kVerts] + sv - nv;
        a.vslot[chunk] = (int)i;
      }
      if (bits) {
        const int64_t j = next[kCellChunks] + __popc(cb & lower);
        a.clist[j] = chunk;
        a.cbase[2 * j] = next[kCents] + sc - nc;
        a.cbase[2 * j + 1] = next[kFaces] + sf - nf;
      }
      next[kVerts] += __shfl_sync(~0u, sv, 31);
      next[kCents] += __shfl_sync(~0u, sc, 31);
      next[kFaces] += __shfl_sync(~0u, sf, 31);
      next[kVertChunks] += __popc(vb);
      next[kCellChunks] += __popc(cb);
    }
  }
}

// 3: the vertices of each listed chunk
__device__ void write_vertices(const EmitArgs& a) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const uint32_t lower = (1u << lane) - 1u;
  for (int64_t i = warp_id(); i < a.vchunks; i += warps_in_grid()) {
    const int64_t chunk = a.vlist[i], row = chunk / d.words;
    const int w = (int)(chunk % d.words), x = (int)(row / d.ny), y = (int)(row % d.ny);
    const int z = w * 32 + lane;
    // each cell row's word of cells z and the top bit of the word before
    // (cell z - 1 of lane 0): q = 2 i + j is cell row (x - i, y - j), absent
    // (no bits) outside the cells; a row has no bit at or past NZ - 1
    bool at[4], below[4];
    for (int q = 0; q < 4; ++q) {
      const int rx = x - (q >> 1), ry = y - (q & 1);
      uint32_t cur = 0u, prv = 0u;
      if (rx >= 0 && rx < d.nx - 1 && ry >= 0 && ry < d.ny - 1) {
        const uint2* m = a.cw + ((int64_t)rx * d.ny + ry) * d.words;
        cur = m[w].x;
        prv = w > 0 ? m[w - 1].x >> 31 : 0u;
      }
      at[q] = (cur >> lane) & 1u;
      below[q] = lane > 0 ? (cur >> (lane - 1)) & 1u : prv != 0u;
    }
    // an edge's cells: axis 0 (x, y - j, z - k), axis 1 (x - i, y, z - k),
    // axis 2 (x - i, y - j, z)
    const bool h[3] = {at[0] || at[1] || below[0] || below[1],
                       at[0] || at[2] || below[0] || below[2],
                       at[0] || at[1] || at[2] || at[3]};
    float v0 = 0.f, v1[3] = {0.f, 0.f, 0.f};
    bool e[3] = {false, false, false};
    if (h[0] || h[1] || h[2]) {
      v0 = a.tsdf[corner(d, x, y, z)];
      const bool in0 = !(v0 > 0.f);
      for (int ax = 0; ax < 3; ++ax) {
        if (!h[ax]) continue;
        v1[ax] = a.tsdf[corner(d, x + (ax == 0), y + (ax == 1), z + (ax == 2))];
        e[ax] = in0 != !(v1[ax] > 0.f);
      }
    }
    const uint32_t b0 = __ballot_sync(~0u, e[0]), b1 = __ballot_sync(~0u, e[1]),
                   b2 = __ballot_sync(~0u, e[2]);
    if (lane == 0) a.vbits[i] = make_uint4(b0, b1, b2, 0u);
    if (!(e[0] || e[1] || e[2])) continue;
    int64_t id = a.vbase[i] + __popc(b0 & lower) + __popc(b1 & lower) + __popc(b2 & lower);
    const float* c0 = a.colors + corner(d, x, y, z) * 3;
    for (int ax = 0; ax < 3; ++ax) {
      if (!e[ax]) continue;
      const double t = edge_t((double)v0, (double)v1[ax]);
      double p[3] = {(double)x, (double)y, (double)z};
      p[ax] = p[ax] + t;
      to_world(a.f, p, a.verts + id * 3);
      const float* c1 = a.colors + corner(d, x + (ax == 0), y + (ax == 1), z + (ax == 2)) * 3;
      for (int ch = 0; ch < 3; ++ch)
        a.vcols[id * 3 + ch] = (double)c0[ch] * (1.0 - t) + (double)c1[ch] * t;
      ++id;
    }
  }
}

template <bool kWrite>
__global__ void __launch_bounds__(kThreads, 4) mc_verts(EmitArgs a) {
  if (kWrite) write_vertices(a);
  else place_chunks(a);
}

// 4: a warp a listed cell chunk, a lane a cell
__global__ void __launch_bounds__(kThreads, 2) mc_cells_emit(EmitArgs a) {
  __shared__ Tables s;
  // the chunk's corner chunks: corner rows (x + dx, y + dy), q = dx + 2 dy, at
  // its word (q) and the next (4 + q): axis ballots and first vertex
  __shared__ uint4 vbits[kWarps][8];
  __shared__ int64_t vfirst[kWarps][8];
  load_tables(a.tables, s);
  const Dims& d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t j = warp_id(); j < a.cchunks; j += warps_in_grid()) {
    const int64_t chunk = a.clist[j], row = chunk / d.words;
    const int w = (int)(chunk % d.words), x = (int)(row / d.ny), y = (int)(row % d.ny);
    const int z = w * 32 + lane;
    const bool act = (a.cw[chunk].x >> lane) & 1u;
    float v[8];
    int cs = 0;
    uint32_t need = 0u;  // bit q or 4 + q: a crossed edge's base corner lies in that corner chunk
    if (act) {
      for (int k = 0; k < 8; ++k) {
        v[k] = __ldg(a.tsdf + corner(d, x + (k & 1), y + ((k >> 1) & 1), z + (k >> 2)));
        if (!(v[k] > 0.f)) cs |= 1 << k;
      }
      for (int e = 0; e < 12; ++e) {
        const int cb = s.edge_base[e];
        if (((cs >> cb) ^ (cs >> (cb | (1 << (e >> 2))))) & 1)
          need |= 1u << ((cb & 3) + 4 * ((z + (cb >> 2)) >> 5 != w));
      }
    }
    for (int o = 1; o < 32; o <<= 1) need |= __shfl_xor_sync(~0u, need, o);
    if (lane < 8 && ((need >> lane) & 1u)) {
      const int q = lane & 3;
      const int slot = __ldg(a.vslot + ((int64_t)(x + (q & 1)) * d.ny + (y + (q >> 1))) * d.words +
                             w + (lane >> 2));
      vbits[warp][lane] = a.vbits[slot];
      vfirst[warp][lane] = __ldg(a.vbase + slot);
    }
    const int nc = act ? s.ncent[cs] : 0, nf = act ? s.ntri[cs] : 0;
    int ic = nc, jf = nf;  // inclusive scans across the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, ic, o), t = __shfl_up_sync(~0u, jf, o);
      if (lane >= o) {
        ic += u;
        jf += t;
      }
    }
    __syncwarp();
    if (act) {
      const int64_t cfirst = a.nverts + a.cbase[2 * j] + ic - nc,
                    ffirst = a.cbase[2 * j + 1] + jf - nf;
      if (nc) {
        float cc[8][3];  // the corners' colours
        for (int k = 0; k < 8; ++k) {
          const float* c = a.colors + corner(d, x + (k & 1), y + ((k >> 1) & 1), z + (k >> 2)) * 3;
          for (int ch = 0; ch < 3; ++ch) cc[k][ch] = __ldg(c + ch);
        }
        int64_t id = cfirst;
        for (int l = 0; l < kLoops; ++l) {
          const int m = s.loops[cs][l];
          if (m == 0) continue;
          // numpy's sum over the 12 edges of mask x value: from +0, edge by
          // edge; an edge off the loop adds +-0, which leaves a sum begun at
          // +0 as it is (such a sum is never -0)
          double sp[3] = {0.0, 0.0, 0.0}, sc[3] = {0.0, 0.0, 0.0};
          for (uint32_t left = m; left; left &= left - 1) {
            const int e = __ffs(left) - 1, ax = e >> 2, cb = s.edge_base[e], ct = cb | (1 << ax);
            const double t = edge_t((double)v[cb], (double)v[ct]);
            const double g[3] = {(double)(x + (cb & 1)), (double)(y + ((cb >> 1) & 1)),
                                 (double)(z + (cb >> 2))};
            for (int c = 0; c < 3; ++c) {
              sp[c] = sp[c] + (g[c] + t * (double)(c == ax));
              sc[c] = sc[c] + ((double)cc[cb][c] * (1.0 - t) + (double)cc[ct][c] * t);
            }
          }
          const double len = (double)__popc(m);
          double p[3];
          for (int c = 0; c < 3; ++c) p[c] = sp[c] / len;
          to_world(a.f, p, a.verts + id * 3);
          for (int c = 0; c < 3; ++c) a.vcols[id * 3 + c] = sc[c] / len;
          ++id;
        }
      }
      for (int i = 0; i < nf; ++i) {
        for (int k = 0; k < 3; ++k) {
          const int local = s.tri[cs][i][k];
          int64_t vid;
          if (local >= 12) {
            int rank = 0;
            for (int l = 0; l < local - 12; ++l) rank += s.loops[cs][l] != 0;
            vid = cfirst + rank;
          } else {
            // edge `local`'s vertex: its corner chunk's first vertex plus the
            // chunk's vertices before it (by z, then axis)
            const int cb = s.edge_base[local], ax = local >> 2, zc = z + (cb >> 2), bit = zc & 31;
            const int q = (cb & 3) + 4 * ((zc >> 5) != w);
            const uint4 b = vbits[warp][q];
            const uint32_t lower = (1u << bit) - 1u;
            int rank = __popc(b.x & lower) + __popc(b.y & lower) + __popc(b.z & lower);
            if (ax > 0) rank += (b.x >> bit) & 1u;
            if (ax > 1) rank += (b.y >> bit) & 1u;
            vid = vfirst[warp][q] + rank;
          }
          a.faces[(ffirst + i) * 3 + k] = vid;
        }
      }
    }
    __syncwarp();
  }
}

// blocks of `kernel` resident at once on the current device (at least 1)
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

inline unsigned grid_of(int64_t warps, int resident) {
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  return (unsigned)(blocks < resident ? (blocks > 0 ? blocks : 1) : resident);
}

}  // namespace

// Step 1. cw [NX NY][words] uint2; counts [kCounts NX NY + 1] int32, zeroed
// by the caller.
extern "C" int scorp_mc_count(const float* tsdf, const float* weight, int nx, int ny, int nz,
                              const int* tables, uint2* cw, int* counts, void* stream) {
  const Dims d{nx, ny, nz, (nz + 31) / 32};
  const CountArgs a{tsdf, weight, d, tables, cw, counts,
                    (nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, (nz + kTZ - 1) / kTZ};
  const int64_t tiles = (int64_t)a.tx * a.ty * a.tz;
  const int resident = resident_blocks(mc_cells_count);
  mc_cells_count<<<(unsigned)(tiles < resident ? tiles : resident), kThreads, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Steps 2-4. ends [kCounts NX NY] int64: the inclusive scan of counts;
// verts and vcols [nverts + centroids][3] float64, faces [F][3] int64;
// scratch: 4 vchunks + ceil(NX NY words / 2) + 3 cchunks int64 words.
extern "C" int scorp_mc_emit(const float* tsdf, const float* colors, int nx, int ny, int nz,
                             const int* tables, const uint2* cw, const int* counts,
                             const int64_t* ends, size_t nverts,
                             size_t vchunks, size_t cchunks, double ox, double oy, double oz,
                             double voxel, int contract, double scale, double cx, double cy,
                             double cz, double* verts, double* vcols, int64_t* faces,
                             int64_t* scratch, void* stream) {
  const Dims d{nx, ny, nz, (nz + 31) / 32};
  const int64_t chunks = (int64_t)nx * ny * d.words;
  EmitArgs a{tsdf, colors, d, tables, cw, counts, ends, (int64_t)nverts, (int64_t)vchunks,
             (int64_t)cchunks, Xform{{ox, oy, oz}, voxel, contract, scale, {cx, cy, cz}},
             verts, vcols, faces};
  a.vbits = reinterpret_cast<uint4*>(scratch);  // 16-byte aligned first
  a.vslot = reinterpret_cast<int*>(scratch + 2 * vchunks);
  a.vlist = scratch + 2 * vchunks + (chunks + 1) / 2;
  a.vbase = a.vlist + vchunks;
  a.clist = a.vbase + vchunks;
  a.cbase = a.clist + cchunks;
  const cudaStream_t s = (cudaStream_t)stream;
  mc_verts<false><<<grid_of(((int64_t)nx * ny + 31) / 32, 1 << 30), kThreads, 0, s>>>(a);
  mc_verts<true><<<grid_of((int64_t)vchunks, resident_blocks(mc_verts<true>)), kThreads, 0, s>>>(a);
  mc_cells_emit<<<grid_of((int64_t)cchunks, resident_blocks(mc_cells_emit)), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

