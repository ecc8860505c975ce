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
//   order: the sum over the 12 edges, in order, of mask x edge position
//   (and colour) over the loop's length, as numpy's reduction adds them;
// - faces in active-cell order, then TRI_TABLE's order; local id e < 12 is
//   edge e's vertex, 12 + l loop l's centroid.
// Vertices then go to world coordinates in float64: q = (p + 0.5) voxel +
// origin per axis, and for a contracted grid uncontract(q) x scale +
// centre, |q| = sqrt((x^2 + y^2) + z^2) (numpy's order for np.linalg.norm
// over three elements), clipped to [1e-9, 2 - 1e-6]. Built with -fmad=false:
// every product and sum rounds as numpy's does; float64 division and sqrt
// are correctly rounded on the card as in numpy.
//
// Layout: one warp a row of 32-lane chunks along z, eight rows a block. No
// array of the grid's size beyond the grid: one bit an active cell
// (amask, 128 MB at 1024^3) and a few ints a row.
// 1. mc_cells_count, a warp a cell row (x, y): each lane reads its four
//    corner rows' weights at z (z + 1 from the next lane), the tsdf only
//    where all 8 corners are observed; writes the row's active bits and
//    counts its centroids and faces.
// 2. mc_verts<false>, a warp a corner row: an edge of base corner (x, y, z)
//    is held when one of its (up to 4) cells is active in amask (two words
//    of each of the four cell rows around it a chunk; a chunk with no bit
//    is skipped); only then are the tsdf values read; counts the row's
//    vertices.
//    (The wrapper scans the three row counts and reads the totals.)
// 3. mc_verts<true>: the same walk writes each vertex at its row's start
//    plus its rank (ballots over the chunk, then the axis), and its code
//    gz 3 + axis.
// 4. mc_cells_emit, a warp a cell row, chunks with no active bit skipped:
//    centroid and face counts scanned across the warp; a face's edge
//    vertex is found by a binary search of its code in its corner row's
//    codes.
// What bounds it: the weights of every corner (4 B each, read once from
// DRAM, four times through L1/L2), the tsdf of corners of observed cells,
// and the mesh written; steps 2-4 touch only rows near active cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block, a warp a row
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTris = 8;  // TRI_TABLE's triangles a case (the wrapper checks)
constexpr int kLoops = 4;    // MAX_LOOPS
// the wrapper's int32 upload: TRI_TABLE [256][kMaxTris][3] (-1 past the
// case's triangles), LOOP_MASK as 12-bit edge masks [256][kLoops] (0 for a
// loop of 3 or none), EDGE_BASE [12]
constexpr int kTriInts = 256 * kMaxTris * 3;
constexpr int kLoopInts = 256 * kLoops;

struct Dims {
  int nx, ny, nz;  // corners a side
  int words;       // 32-bit words of a cell row's active bits: ceil((nz - 1) / 32)
};

struct Xform {
  double origin[3];
  double voxel;
  int contract;  // 1: uncontract, times scale, plus centre
  double scale;
  double centre[3];
};

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

__device__ __forceinline__ int64_t corner(const Dims& d, int x, int y, int z) {
  return ((int64_t)x * d.ny + y) * d.nz + z;
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

__global__ void __launch_bounds__(kThreads) mc_cells_count(
    const float* __restrict__ tsdf, const float* __restrict__ weight, Dims d,
    const int* __restrict__ tables, uint32_t* __restrict__ amask, int* __restrict__ cents,
    int* __restrict__ faces) {
  __shared__ Tables s;
  load_tables(tables, s);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)d.nx * d.ny) return;
  const int x = (int)(row / d.ny), y = (int)(row % d.ny);
  uint32_t* mrow = amask + row * d.words;
  if (x >= d.nx - 1 || y >= d.ny - 1) {
    for (int w = lane; w < d.words; w += 32) mrow[w] = 0u;
    if (lane == 0) cents[row] = faces[row] = 0;
    return;
  }
  int64_t base[4];  // corner rows (x + dx, y + dy), q = dx + 2 dy
  for (int q = 0; q < 4; ++q) base[q] = corner(d, x + (q & 1), y + (q >> 1), 0);
  int nc = 0, nf = 0;
  for (int w = 0; w < d.words; ++w) {
    const int z = w * 32 + lane;
    float w0[4], w1[4];
    for (int q = 0; q < 4; ++q) w0[q] = z < d.nz ? weight[base[q] + z] : 0.f;
    for (int q = 0; q < 4; ++q) w1[q] = __shfl_down_sync(~0u, w0[q], 1);
    if (lane == 31 && z + 1 < d.nz)
      for (int q = 0; q < 4; ++q) w1[q] = weight[base[q] + z + 1];
    bool obs = z < d.nz - 1;
    for (int q = 0; q < 4; ++q) obs = obs && w0[q] > 0.f && w1[q] > 0.f;
    // the tsdf at z serves this lane (dz = 0) and the one before (dz = 1)
    const bool prev = __shfl_up_sync(~0u, obs, 1) && lane > 0;
    float t0[4], t1[4];
    for (int q = 0; q < 4; ++q) t0[q] = (obs || prev) ? tsdf[base[q] + z] : 1.f;
    for (int q = 0; q < 4; ++q) t1[q] = __shfl_down_sync(~0u, t0[q], 1);
    if (lane == 31 && obs)
      for (int q = 0; q < 4; ++q) t1[q] = tsdf[base[q] + z + 1];
    int cs = 0;
    for (int q = 0; q < 4; ++q) {
      if (!(t0[q] > 0.f)) cs |= 1 << q;
      if (!(t1[q] > 0.f)) cs |= 1 << (q + 4);
    }
    const bool act = obs && cs != 0 && cs != 255;
    const uint32_t bits = __ballot_sync(~0u, act);
    if (lane == 0) mrow[w] = bits;
    if (act) {
      nc += s.ncent[cs];
      nf += s.ntri[cs];
    }
  }
  nc = __reduce_add_sync(~0u, nc);
  nf = __reduce_add_sync(~0u, nf);
  if (lane == 0) {
    cents[row] = nc;
    faces[row] = nf;
  }
}

// kEmit false: count each corner row's vertices into vcount; true: write
// them from vstart[row] on (positions, colours, codes)
template <bool kEmit>
__global__ void __launch_bounds__(kThreads) mc_verts(
    const float* __restrict__ tsdf, const float* __restrict__ colors, Dims d,
    const uint32_t* __restrict__ amask, int* __restrict__ vcount,
    const int64_t* __restrict__ vstart, Xform f, double* __restrict__ verts,
    double* __restrict__ vcols, int* __restrict__ vcode) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)d.nx * d.ny) return;
  const int x = (int)(row / d.ny), y = (int)(row % d.ny);
  const uint32_t lower = (1u << lane) - 1u;
  int64_t next = kEmit ? vstart[row] : 0;
  int n = 0;
  // the active bits of the cell rows around corner row (x, y): q = 2 i + j
  // is cell row (x - i, y - j), absent (no bits) outside the cells
  const uint32_t* rows[4];
  for (int q = 0; q < 4; ++q) {
    const int rx = x - (q >> 1), ry = y - (q & 1);
    rows[q] = rx >= 0 && rx < d.nx - 1 && ry >= 0 && ry < d.ny - 1
                  ? amask + ((int64_t)rx * d.ny + ry) * d.words : nullptr;
  }
  for (int w = 0; w * 32 < d.nz; ++w) {
    const int z = w * 32 + lane;
    // each row's word of cells z and the top bit of the word before (cell
    // z - 1 of lane 0); a cell row has no bit at or past NZ - 1
    uint32_t cur[4], prv[4], any = 0u;
    for (int q = 0; q < 4; ++q) {
      cur[q] = rows[q] && w < d.words ? rows[q][w] : 0u;
      prv[q] = rows[q] && w > 0 ? rows[q][w - 1] >> 31 : 0u;
      any |= cur[q] | prv[q];
    }
    if (any == 0u) continue;
    bool at[4], below[4];  // cell z, cell z - 1 of each row
    for (int q = 0; q < 4; ++q) {
      at[q] = (cur[q] >> lane) & 1u;
      below[q] = lane > 0 ? (cur[q] >> (lane - 1)) & 1u : prv[q] != 0u;
    }
    // an edge's cells: axis 0 (x, y - j, z - k), axis 1 (x - i, y, z - k),
    // axis 2 (x - i, y - j, z)
    const bool h[3] = {at[0] || at[1] || below[0] || below[1],
                       at[0] || at[2] || below[0] || below[2],
                       at[0] || at[1] || at[2] || at[3]};
    float v0 = 0.f, v1[3] = {0.f, 0.f, 0.f};
    bool e[3] = {false, false, false};
    if (h[0] || h[1] || h[2]) {
      v0 = tsdf[corner(d, x, y, z)];
      const bool in0 = !(v0 > 0.f);
      const int64_t other[3] = {h[0] ? corner(d, x + 1, y, z) : 0,
                                h[1] ? corner(d, x, y + 1, z) : 0,
                                h[2] ? corner(d, x, y, z + 1) : 0};
      for (int a = 0; a < 3; ++a) {
        if (!h[a]) continue;
        v1[a] = tsdf[other[a]];
        e[a] = in0 != !(v1[a] > 0.f);
      }
    }
    const uint32_t b0 = __ballot_sync(~0u, e[0]), b1 = __ballot_sync(~0u, e[1]),
                   b2 = __ballot_sync(~0u, e[2]);
    if (kEmit && (e[0] || e[1] || e[2])) {
      int64_t id = next + __popc(b0 & lower) + __popc(b1 & lower) + __popc(b2 & lower);
      const float* c0 = colors + corner(d, x, y, z) * 3;
      for (int a = 0; a < 3; ++a) {
        if (!e[a]) continue;
        const double t = edge_t((double)v0, (double)v1[a]);
        double p[3] = {(double)x, (double)y, (double)z};
        p[a] = p[a] + t;
        to_world(f, p, verts + id * 3);
        const float* c1 = colors + corner(d, x + (a == 0), y + (a == 1), z + (a == 2)) * 3;
        for (int ch = 0; ch < 3; ++ch)
          vcols[id * 3 + ch] = (double)c0[ch] * (1.0 - t) + (double)c1[ch] * t;
        vcode[id] = z * 3 + a;
        ++id;
      }
    }
    const int total = __popc(b0) + __popc(b1) + __popc(b2);
    n += total;
    next += total;
  }
  if (!kEmit && lane == 0) vcount[row] = n;
}

// the vertex of edge e of cell (x, y, z): a binary search of its code in
// the codes of its base corner's row
__device__ int64_t edge_vertex(const Dims& d, const Tables& s, const int* __restrict__ vcount,
                               const int64_t* __restrict__ vstart, const int* __restrict__ vcode,
                               int x, int y, int z, int e) {
  const int cb = s.edge_base[e];
  const int64_t r = (int64_t)(x + (cb & 1)) * d.ny + (y + ((cb >> 1) & 1));
  const int code = (z + (cb >> 2)) * 3 + (e >> 2);
  int64_t lo = vstart[r], hi = lo + vcount[r];
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (vcode[mid] < code) lo = mid + 1; else hi = mid;
  }
  return (lo < vstart[r] + vcount[r] && vcode[lo] == code) ? lo : -1;
}

__global__ void __launch_bounds__(kThreads) mc_cells_emit(
    const float* __restrict__ tsdf, const float* __restrict__ colors, Dims d,
    const int* __restrict__ tables, const uint32_t* __restrict__ amask,
    const int* __restrict__ vcount, const int64_t* __restrict__ vstart,
    const int* __restrict__ vcode, const int64_t* __restrict__ cstart,
    const int64_t* __restrict__ fstart, int64_t nverts, Xform f, double* __restrict__ verts,
    double* __restrict__ vcols, int64_t* __restrict__ faces) {
  __shared__ Tables s;
  load_tables(tables, s);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (int64_t)d.nx * d.ny) return;
  const int x = (int)(row / d.ny), y = (int)(row % d.ny);
  if (x >= d.nx - 1 || y >= d.ny - 1) return;
  int64_t cnext = nverts + cstart[row], fnext = fstart[row];
  for (int w = 0; w < d.words; ++w) {
    const uint32_t bits = amask[row * d.words + w];
    if (bits == 0u) continue;
    const int z = w * 32 + lane;
    const bool act = (bits >> lane) & 1u;
    double v[8];
    int cs = 0;
    if (act) {
      for (int k = 0; k < 8; ++k) {
        v[k] = (double)tsdf[corner(d, x + (k & 1), y + ((k >> 1) & 1), z + (k >> 2))];
        if (!(v[k] > 0.0)) cs |= 1 << k;
      }
    }
    const int nc = act ? s.ncent[cs] : 0, nf = act ? s.ntri[cs] : 0;
    int ic = nc, jf = nf;  // inclusive scans across the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(~0u, ic, o), b = __shfl_up_sync(~0u, jf, o);
      if (lane >= o) {
        ic += a;
        jf += b;
      }
    }
    const int tc = __shfl_sync(~0u, ic, 31), tf = __shfl_sync(~0u, jf, 31);
    const int64_t cbase = cnext + ic - nc, fbase = fnext + jf - nf;
    cnext += tc;
    fnext += tf;
    if (!act) continue;
    if (nc > 0) {
      float cc[8][3];
      for (int k = 0; k < 8; ++k) {
        const float* src = colors + corner(d, x + (k & 1), y + ((k >> 1) & 1), z + (k >> 2)) * 3;
        for (int ch = 0; ch < 3; ++ch) cc[k][ch] = src[ch];
      }
      int64_t id = cbase;
      for (int l = 0; l < kLoops; ++l) {
        const int m = s.loops[cs][l];
        if (m == 0) continue;
        double sp[3], sc[3];
        for (int e = 0; e < 12; ++e) {
          const int a = e >> 2, cb = s.edge_base[e], ct = cb | (1 << a);
          const double t = edge_t(v[cb], v[ct]);
          const double g[3] = {(double)(x + (cb & 1)), (double)(y + ((cb >> 1) & 1)),
                               (double)(z + (cb >> 2))};
          const double on = (double)((m >> e) & 1);
          for (int c = 0; c < 3; ++c) {
            const double pos = g[c] + t * (double)(c == a);
            const double col = (double)cc[cb][c] * (1.0 - t) + (double)cc[ct][c] * t;
            if (e == 0) {
              sp[c] = on * pos;
              sc[c] = on * col;
            } else {
              sp[c] = sp[c] + on * pos;
              sc[c] = sc[c] + on * col;
            }
          }
        }
        const double len = (double)__popc(m);
        double p[3];
        for (int c = 0; c < 3; ++c) p[c] = sp[c] / len;
        to_world(f, p, verts + id * 3);
        for (int c = 0; c < 3; ++c) vcols[id * 3 + c] = sc[c] / len;
        ++id;
      }
    }
    for (int i = 0; i < nf; ++i) {
      for (int j = 0; j < 3; ++j) {
        const int local = s.tri[cs][i][j];
        int64_t vid;
        if (local >= 12) {
          int rank = 0;
          for (int l = 0; l < local - 12; ++l) rank += s.loops[cs][l] != 0;
          vid = cbase + rank;
        } else {
          vid = edge_vertex(d, s, vcount, vstart, vcode, x, y, z, local);
        }
        faces[(fbase + i) * 3 + j] = vid;
      }
    }
  }
}

inline int64_t blocks_of(const Dims& d) {
  return ((int64_t)d.nx * d.ny + kWarps - 1) / kWarps;
}

}  // namespace

// counts [3][NX NY] int32: each corner row's vertices, each cell row's
// centroids and faces; amask [NX NY][words] uint32. Steps 1 and 2.
extern "C" int scorp_mc_count(const float* tsdf, const float* weight, int nx, int ny, int nz,
                              const int* tables, uint32_t* amask, int* counts, void* stream) {
  const Dims d{nx, ny, nz, (nz - 1 + 31) / 32};
  const int64_t rows = (int64_t)nx * ny;
  const cudaStream_t s = (cudaStream_t)stream;
  mc_cells_count<<<(unsigned)blocks_of(d), kThreads, 0, s>>>(tsdf, weight, d, tables, amask,
                                                             counts + rows, counts + 2 * rows);
  mc_verts<false><<<(unsigned)blocks_of(d), kThreads, 0, s>>>(
      tsdf, nullptr, d, amask, counts, nullptr, Xform{}, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// starts [3][NX NY] int64: the exclusive scans of counts; verts and vcols
// [nverts + centroids][3] float64, faces [F][3] int64, vcode [nverts] int32
// (scratch). Steps 3 and 4.
extern "C" int scorp_mc_emit(const float* tsdf, const float* colors, int nx, int ny, int nz,
                             const int* tables, const uint32_t* amask, const int* counts,
                             const int64_t* starts, size_t nverts, double ox, double oy,
                             double oz, double voxel, int contract, double scale, double cx,
                             double cy, double cz, double* verts, double* vcols,
                             int64_t* faces, int* vcode, void* stream) {
  const Dims d{nx, ny, nz, (nz - 1 + 31) / 32};
  const int64_t rows = (int64_t)nx * ny;
  const Xform f{{ox, oy, oz}, voxel, contract, scale, {cx, cy, cz}};
  const cudaStream_t s = (cudaStream_t)stream;
  mc_verts<true><<<(unsigned)blocks_of(d), kThreads, 0, s>>>(tsdf, colors, d, amask, nullptr,
                                                             starts, f, verts, vcols, vcode);
  mc_cells_emit<<<(unsigned)blocks_of(d), kThreads, 0, s>>>(
      tsdf, colors, d, tables, amask, counts, starts, vcode, starts + rows, starts + 2 * rows,
      (int64_t)nverts, f, verts, vcols, faces);
  return (int)cudaGetLastError();
}
