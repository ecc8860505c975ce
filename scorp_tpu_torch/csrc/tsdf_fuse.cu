// Kernel T: one view's TSDF update of a dense voxel grid, in place. The grid
// is walked as bricks of B^3 voxels; a brick that no voxel of it can update
// is culled by one float64 test before any voxel centre is made, and the
// voxels of every other brick make their world centre from their index,
// project it into the view, take the four bilinear taps of the depth map
// and, where the voxel is valid, of the three colour planes, and update the
// truncated running average of tsdf, weight and colour.
//
// Replaces no TPU kernel: the JAX package's TSDF update
// (scorp_tpu/pipeline/mesh.py) is plain jitted XLA over a voxel array that
// the host builds. Its plain PyTorch version (scorp_tpu_torch/pipeline/
// mesh.py:_tsdf_update) allocates dozens of grid-sized temporaries a view,
// and the contracted grid's coordinates are an [R^3, 3] array; at the 2DGS
// reference code's unbounded resolution (1024^3) neither fits the card. The
// wrapper: scorp_tpu_torch/ops/tsdf.py (it picks the brick and lattice
// sizes); pipeline/mesh.py:TsdfVolume calls it for every view on the card.
//
// Grid (flat index n = (i R + j) R + k over an R^3 grid; tsdf [R^3],
// weight [R^3], colors [R^3][3], f32):
// - bounded: the centre of voxel (i, j, k) is (idx + 0.5) * voxel_size +
//   origin per axis, in float64, rounded to f32;
// - contracted: c = (idx + 0.5) * step - 2 per axis (step = 4 / R), pulled
//   onto the shell |c| = 1.98 where |c| >= 1.98, uncontracted (c where
//   |c| <= 1, else c / (s (2 - s)) with s = |c| clipped to [1e-9, 2 - 1e-6]),
//   times scale_radius plus the centre, all in float64 and rounded to f32.
//   |c| is sqrt((x^2 + y^2) + z^2), numpy's order for np.linalg.norm over
//   three elements; float64 sqrt and division are correctly rounded here as
//   in numpy.
// The view: viewmatrix [4][4] (W2C^T, row-vector style), tanfovx and
// tanfovy (0-d f32) on the device; fx = W / (2 tanfovx) in float64 rounded
// to f32, as the plain caller forms it, so the call reads nothing to the
// host. depth [H][W] and color [3][H][W], f32.
//
// Bricks: brick (bi, bj, bk) holds the voxels (bi B + li, bj B + lj,
// bk B + lk), 0 <= l < B, that lie inside the grid (the far faces' bricks
// are partial when B does not divide R). A block of 64 threads tests the
// L^3 bricks (ti G_i + blockIdx.z, tj G_j + blockIdx.y, tk G_k +
// blockIdx.x), one a thread (G = ceil(bricks a side / L) blocks a side),
// a lattice spread over the whole grid, so the few bricks a view can update
// fall evenly over the blocks. The view's cull quantities are made once a
// block, in shared memory. The block lists its live bricks in shared memory
// and walks their voxels, 64 a step, the threads of a warp along k; (i, j,
// k) come from the brick and thread coordinates in 32-bit integers, with no
// division. One atomicAdd a block adds its live bricks to the launch's
// count.
//
// The cull (brick_live), in float64, conservative by construction. A voxel
// updates only where z > 1e-4, (u, v) lies in the image, the sampled d <
// depth_trunc and (d - z) / sdf_trunc > -1. In the f32 values the kernel
// computes, that implies (derivations beside the code):
//   1e-4 < Z < zfar = (depth_trunc + sdf_trunc (1 + 2^-20)) (1 + 2^-50),
//   |X| <= tx Z and |Y| <= ty Z, tx = (cx + 1) / fx, ty = (cy + 1) / fy,
// (X, Y, Z) the voxel's view coordinates: a pixel of slack around the image
// takes up the rounding of x / z and of the projection. Each of the six
// bounds is linear in the world centre, so a brick is culled when the least
// of one linear function over its voxels' centres passes its bound. The
// least is taken over a region that holds every centre (Region::lin_min):
// - bounded: the box of the brick's float64 centres, exact (its support
//   function);
// - contracted: the shell-and-cone base + scale rho w, rho between the
//   world radii of the box's nearest and farthest contracted points (after
//   the 1.98 clip), w within the cone of the box's directions from the
//   grid's centre. A ball around the image of the box centre, sized by the
//   map's largest derivative (1 / (2 - |c|)^2), is up to 2.3x larger in
//   live bricks on a room's 256^3 grid: the outer bricks span world radii
//   of 2.5 to 4.9 scene radii, and only their radial extent is that large.
// The region grows by 2^-19 (|base| + |P|) for the f32 rounding of each
// centre and the float64 rounding of the centres and of the bound, and each
// view row's f32 sum of four products is within 2^-20 (|p| |row| + |off|)
// of its exact value (three roundings deep: 3 x 2^-24 at most). Nothing
// assumes the view matrix is rigid.
//
// Numerics of a live brick's voxels: _tsdf_update's operations in its
// order, built with -fmad=false: the projection's four terms summed
// pairwise, (x a + y b) + (z c + d); each of its multiply-adds that XLA's
// CPU code contracts (_fma) as a float64 product (exact) plus a float64
// add, rounded once to f32 (fma64); every other operation in f32. A voxel
// that is behind the camera, outside the image or not valid is left as it
// is: the plain version writes it back unchanged (its weight gains +0), so
// skipping it, or its whole brick, writes the same grid.
//
// What bounds it on an H100: the voxels of live bricks, each of which
// pays its float64 centre (in the contracted grid two float64 square roots,
// two divisions and ~30 more float64 operations) and its projection; the
// H100's float64 rate is half its f32 rate (~34 against ~67 TFLOP/s), so
// the cost is the number of such voxels, not a slow float64 unit. On a
// room's view 2-4% of the bricks are live, and their voxels in the image
// read the depth taps, the valid ones the colour taps and their 20 bytes
// of state. The culled bricks cost one float64 test each (~10^2
// operations). The least bytes a view needs are those valid voxels' state
// read and written (40 B each) and the two maps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // two warps: each thread tests one lattice brick
// at most 64 registers a thread, 16 blocks an SM: the brick test's float64
// state spills a little, the voxels run at twice the occupancy of the
// unbounded build (96 registers), ~0.75 against ~0.89 ms on a room's view
constexpr int kMinBlocks = 16;

struct Grid {
  int contracted;   // 0: bounded, 1: contracted
  int res;          // R
  double base[3];   // bounded: origin; contracted: the scene's centre
  double scale;     // bounded: voxel size; contracted: scale_radius
  double step;      // contracted: 4 / R
};

struct Layout {
  int brick_log2;    // B = 2^brick_log2 voxels a side
  int lattice_log2;  // L = 2^lattice_log2 bricks a side tested by one block
  int bricks;        // ceil(R / B) bricks a side
};

// a * b + c: the f32 product exact in float64, the sum rounded to float64
// and then to f32, as _fma does it.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn((double)a * (double)b + (double)c);
}

__device__ __forceinline__ double norm3(const double p[3]) {
  return sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]);
}

__device__ __forceinline__ void voxel_centre(const Grid& g, const int idx[3], float out[3]) {
  if (!g.contracted) {
    for (int a = 0; a < 3; ++a)
      out[a] = __double2float_rn(((double)idx[a] + 0.5) * g.scale + g.base[a]);
    return;
  }
  double p[3];
  for (int a = 0; a < 3; ++a) p[a] = ((double)idx[a] + 0.5) * g.step - 2.0;
  const double cn = norm3(p);
  if (cn >= 1.98) {
    const double f = 1.98 / fmax(cn, 1e-9);
    for (int a = 0; a < 3; ++a) p[a] = p[a] * f;
  }
  const double nn = norm3(p);
  if (!(nn <= 1.0)) {
    const double safe = fmin(fmax(nn, 1e-9), 2.0 - 1e-6);
    const double den = safe * (2.0 - safe);
    for (int a = 0; a < 3; ++a) p[a] = p[a] / den;
  }
  for (int a = 0; a < 3; ++a) out[a] = __double2float_rn(p[a] * g.scale + g.base[a]);
}

// _tsdf_update's sample(): the four bilinear taps of one plane
__device__ __forceinline__ float sample(const float* __restrict__ img, int i00, int i01,
                                        int i10, int i11, float au, float av) {
  float s = fma64(img[i00] * (1.0f - au), 1.0f - av, img[i01] * au * (1.0f - av));
  s = fma64(img[i10] * (1.0f - au), av, s);
  return fma64(img[i11] * au, av, s);
}

// The view as every voxel reads it: the matrix and the f32 intrinsics the
// plain caller forms.
struct View {
  const float* __restrict__ m;
  float fx, fy, cx, cy;
  int width, height;
};

// The camera's float64 quantities the brick test reads (see the header).
struct CullView {
  double row[3][3], off[3];  // view row c of a world point p: row[c] . p + off[c]
  double nrow[3];            // |row[c]|
  double tx, ty;             // the side planes' slopes, a pixel of slack included
  double zfar;               // no voxel at Z >= zfar updates
};

__device__ CullView cull_view(const View& w, float sdf_trunc, float depth_trunc) {
  CullView c;
  for (int r = 0; r < 3; ++r) {
    for (int a = 0; a < 3; ++a) c.row[r][a] = (double)w.m[4 * a + r];
    c.off[r] = (double)w.m[12 + r];
    c.nrow[r] = norm3(c.row[r]);
  }
  // A voxel in the image has 0 <= u <= W - 1 with u = f32(f64(q fx + cx)),
  // q = f32(X / Z). Then q fx + cx <= (W - 1)(1 + 2^-22), and as cx = W/2 -
  // 1/2 exactly, X / Z <= q (1 + 2^-23) <= (cx + (W - 1) 2^-22)(1 + 2^-23) /
  // fx < (cx + 1) / fx for any W under 2^20; the same below 0 and in v.
  c.tx = ((double)w.cx + 1.0) / (double)w.fx * (1.0 + 0x1p-40);
  c.ty = ((double)w.cy + 1.0) / (double)w.fy * (1.0 + 0x1p-40);
  // d < depth_trunc and f32(f32(d - Z) / sdf_trunc) > -1: at Z >= dt + st
  // (1 + 2^-20), f32(d - Z) <= -st (1 + 2^-20)(1 - 2^-24) < -st, so the
  // quotient is <= -1 after rounding. The last factor covers this sum's
  // own rounding whatever dt / st is.
  c.zfar = ((double)depth_trunc + (double)sdf_trunc * (1.0 + 0x1p-20)) * (1.0 + 0x1p-50);
  return c;
}

// A lower bound of a . p + b over the f32 centres p of one brick's voxels.
struct Region {
  int contracted;
  // bounded: the box of the float64 centres
  double centre[3], half[3];
  // contracted: base + scale rho w, rho in [rho_n, rho_f], w a unit vector
  // within the cone of axis w0 and half-angle (sin_a, cos_a) (full: all w)
  double base[3], scale, rho_n, rho_f, w0[3], sin_a, cos_a;
  int full;
  double slack;  // |p - P| for the f32 centre p of the exact centre P
  double pmax;   // |p| for every centre p

  __device__ double lin_min(const double a[3], double b) const {
    const double na = norm3(a);
    if (!contracted)
      return a[0] * centre[0] + a[1] * centre[1] + a[2] * centre[2] + b -
             (fabs(a[0]) * half[0] + fabs(a[1]) * half[1] + fabs(a[2]) * half[2]) -
             na * slack;
    // the least a . w over the cone: |a| cos(min(pi, angle(a, w0) + alpha)),
    // less 2^-20 |a| for the rounding of the cosines
    const double ct = na > 0.0 ? fmin(fmax((a[0] * w0[0] + a[1] * w0[1] + a[2] * w0[2]) / na,
                                           -1.0), 1.0) : 0.0;
    const double st = sqrt(fmax(0.0, 1.0 - ct * ct));
    const double m = ((full || ct < -cos_a) ? -1.0 : ct * cos_a - st * sin_a) * na -
                     0x1p-20 * na;
    return a[0] * base[0] + a[1] * base[1] + a[2] * base[2] + b +
           scale * fmin(rho_n * m, rho_f * m) - na * slack;
  }
};

__device__ Region brick_region(const Grid& g, const Layout& lay, const int b[3]) {
  Region r;
  r.contracted = g.contracted;
  const int bs = 1 << lay.brick_log2;
  double lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const int first = b[a] * bs, last = min(first + bs, g.res) - 1;
    // the voxel code's own float64 formulas, monotone in the index
    if (g.contracted) {
      lo[a] = ((double)first + 0.5) * g.step - 2.0;
      hi[a] = ((double)last + 0.5) * g.step - 2.0;
    } else {
      lo[a] = ((double)first + 0.5) * g.scale + g.base[a];
      hi[a] = ((double)last + 0.5) * g.scale + g.base[a];
    }
    r.centre[a] = 0.5 * (lo[a] + hi[a]);
    r.half[a] = 0.5 * (hi[a] - lo[a]);
  }
  const double nbase = norm3(g.base);
  if (!g.contracted) {
    // the f32 rounding of each centre (2^-24 |P|) and every float64 rounding
    r.slack = 0x1p-19 * (nbase + norm3(r.centre) + norm3(r.half));
    r.pmax = norm3(r.centre) + norm3(r.half) + r.slack;
    return r;
  }
  // The box's centres c lie in the ball of radius |half| around its centre
  // c0, so their directions within asin(|half| / |c0|) of c0's; the clip to
  // |c| = 1.98 keeps the direction, and the uncontraction maps |c| to the
  // world radius rho(min(|c|, 1.98)) (rho(s) = s for s <= 1, 1 / (2 - s)
  // beyond), which grows with |c|.
  double near[3], far[3];
  for (int a = 0; a < 3; ++a) {
    near[a] = fmin(fmax(0.0, lo[a]), hi[a]);
    far[a] = fmax(fabs(lo[a]), fabs(hi[a]));
    r.base[a] = g.base[a];
  }
  r.scale = g.scale;
  const double s_near = fmin(norm3(near), 1.98), s_far = fmin(norm3(far), 1.98);
  r.rho_n = (s_near <= 1.0 ? s_near : 1.0 / (2.0 - s_near)) * (1.0 - 0x1p-40);
  r.rho_f = (s_far <= 1.0 ? s_far : 1.0 / (2.0 - s_far)) * (1.0 + 0x1p-40);
  const double hd = norm3(r.half), s0 = norm3(r.centre);
  r.full = !(hd < s0 * (1.0 - 0x1p-30));
  r.sin_a = r.full ? 1.0 : fmin(1.0, hd / s0 * (1.0 + 0x1p-30) + 0x1p-40);
  r.cos_a = r.full ? -1.0 : sqrt(fmax(0.0, 1.0 - r.sin_a * r.sin_a)) * (1.0 - 0x1p-40);
  for (int a = 0; a < 3; ++a) r.w0[a] = s0 > 0.0 ? r.centre[a] / s0 : 0.0;
  r.pmax = nbase + g.scale * r.rho_f;
  r.slack = 0x1p-19 * r.pmax;
  r.pmax += r.slack;
  return r;
}

// False only when no voxel of the brick can pass T's tests (see the header).
__device__ bool brick_live(const Grid& g, const Layout& lay, const CullView& v,
                           const int b[3]) {
  const Region r = brick_region(g, lay, b);
  // each view row's f32 sum, within 2^-20 (|p| |row| + |off|) of its exact
  // value (1e-30: underflow)
  double e[3];
  for (int c = 0; c < 3; ++c) e[c] = 0x1p-20 * (r.pmax * v.nrow[c] + fabs(v.off[c])) + 1e-30;
  const double neg_z[3] = {-v.row[2][0], -v.row[2][1], -v.row[2][2]};
  if (-r.lin_min(neg_z, -v.off[2]) + e[2] <= (double)1e-4f) return false;  // behind
  if (r.lin_min(v.row[2], v.off[2]) - e[2] >= v.zfar) return false;        // beyond reach
  // outside a side plane: s X - t Z > 0 for s = -1 and 1, in X and in Y
  for (int c = 0; c < 2; ++c) {
    const double t = c == 0 ? v.tx : v.ty;
    for (int s = -1; s <= 1; s += 2) {
      double a[3];
      for (int k = 0; k < 3; ++k) a[k] = s * v.row[c][k] - t * v.row[2][k];
      if (r.lin_min(a, s * v.off[c] - t * v.off[2]) - e[c] - t * e[2] > 0.0) return false;
    }
  }
  return true;
}

// One voxel's update: _tsdf_update's operations in its order.
__device__ __forceinline__ void fuse_voxel(const Grid& g, const View& w, const int idx[3],
                                           const float* __restrict__ depth,
                                           const float* __restrict__ color, float sdf_trunc,
                                           float depth_trunc, float* __restrict__ tsdf,
                                           float* __restrict__ weight,
                                           float* __restrict__ colors) {
  float p[3];
  voxel_centre(g, idx, p);
  const float* vm = w.m;
  const float x = p[0], y = p[1], zw = p[2];
  // [x, y, z, 1] @ view_t[:, c]
  const float z = (x * vm[2] + y * vm[6]) + (zw * vm[10] + vm[14]);
  if (!(z > 1e-4f)) return;
  const float vx = (x * vm[0] + y * vm[4]) + (zw * vm[8] + vm[12]);
  const float vy = (x * vm[1] + y * vm[5]) + (zw * vm[9] + vm[13]);
  const float u = fma64(vx / z, w.fx, w.cx);
  const float v = fma64(vy / z, w.fy, w.cy);
  const int width = w.width, height = w.height;
  const float wmax = (float)(width - 1), hmax = (float)(height - 1);
  if (!(u >= 0.0f && u <= wmax && v >= 0.0f && v <= hmax)) return;
  // inside the image: u, v need no clamp
  const int u0 = (int)floorf(u), v0 = (int)floorf(v);
  const int u1 = min(u0 + 1, width - 1), v1 = min(v0 + 1, height - 1);
  const float au = u - (float)u0, av = v - (float)v0;
  const int i00 = v0 * width + u0, i01 = v0 * width + u1;
  const int i10 = v1 * width + u0, i11 = v1 * width + u1;
  const float d = sample(depth, i00, i01, i10, i11, au, av);
  if (!(d > 1e-4f && d < depth_trunc)) return;
  float sdf = (d - z) / sdf_trunc;
  if (!(sdf > -1.0f)) return;
  sdf = fminf(fmaxf(sdf, -1.0f), 1.0f);
  const int64_t n = ((int64_t)idx[0] * g.res + idx[1]) * g.res + idx[2];
  const float wt = weight[n];
  const float w_tot = wt + 1.0f;
  const float w_safe = fmaxf(w_tot, 1e-8f);
  tsdf[n] = fma64(tsdf[n], wt, sdf) / w_safe;
  weight[n] = w_tot;
  const int64_t plane = (int64_t)width * height;
  float* c = colors + 3 * n;
  for (int ch = 0; ch < 3; ++ch) {
    const float s = sample(color + ch * plane, i00, i01, i10, i11, au, av);
    c[ch] = fma64(c[ch], wt, s) / w_safe;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tsdf_fuse_kernel(Grid g, Layout lay, const float* __restrict__ vm,
                 const float* __restrict__ tanfovx, const float* __restrict__ tanfovy,
                 const float* __restrict__ depth, const float* __restrict__ color, int width,
                 int height, float sdf_trunc, float depth_trunc, float* __restrict__ tsdf,
                 float* __restrict__ weight, float* __restrict__ colors,
                 unsigned long long* __restrict__ live_bricks) {
  __shared__ CullView cull;
  __shared__ unsigned int ballots[kThreads / 32];
  __shared__ int firsts[kThreads][3];  // the live bricks' first voxels, in thread order
  View w;
  w.m = vm;
  w.fx = __double2float_rn((double)width / (2.0 * (double)*tanfovx));
  w.fy = __double2float_rn((double)height / (2.0 * (double)*tanfovy));
  w.cx = __double2float_rn((double)width * 0.5 - 0.5);
  w.cy = __double2float_rn((double)height * 0.5 - 0.5);
  w.width = width;
  w.height = height;

  // this thread's lattice brick
  const int t = threadIdx.x, lg = lay.lattice_log2, lmask = (1 << lg) - 1;
  if (t == 0) cull = cull_view(w, sdf_trunc, depth_trunc);
  __syncthreads();
  const unsigned gdim[3] = {gridDim.z, gridDim.y, gridDim.x};
  const unsigned bidx[3] = {blockIdx.z, blockIdx.y, blockIdx.x};
  const int tl[3] = {t >> (2 * lg), (t >> lg) & lmask, t & lmask};
  bool live = t < (1 << (3 * lg));
  int b[3];
  for (int a = 0; a < 3; ++a) {
    b[a] = tl[a] * (int)gdim[a] + (int)bidx[a];
    live = live && b[a] < lay.bricks;
  }
  if (live) live = brick_live(g, lay, cull, b);
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((t & 31) == 0) ballots[t >> 5] = ballot;
  __syncthreads();
  int n_live = 0, at = 0;
  for (int k = 0; k < kThreads / 32; ++k) {
    if (k == (t >> 5)) at = n_live + __popc(ballot & ((1u << (t & 31)) - 1u));
    n_live += __popc(ballots[k]);
  }
  if (n_live == 0) return;
  const int bl = lay.brick_log2;
  if (live)
    for (int a = 0; a < 3; ++a) firsts[at][a] = b[a] << bl;
  if (t == 0) atomicAdd(live_bricks, (unsigned long long)n_live);
  __syncthreads();

  // the live bricks' voxels, 64 a step, the threads of a warp along k
  const int vb = 3 * bl, vmask = (1 << vb) - 1, bmask = (1 << bl) - 1;
  for (int e = t; e < (n_live << vb); e += kThreads) {
    const int* f = firsts[e >> vb];
    const int v = e & vmask;
    const int idx[3] = {f[0] + (v >> (2 * bl)), f[1] + ((v >> bl) & bmask), f[2] + (v & bmask)};
    if (idx[0] < g.res && idx[1] < g.res && idx[2] < g.res)
      fuse_voxel(g, w, idx, depth, color, sdf_trunc, depth_trunc, tsdf, weight, colors);
  }
}

}  // namespace

extern "C" int scorp_tsdf_fuse(int contracted, int res, int brick_log2, int lattice_log2,
                               double base_x, double base_y, double base_z, double scale,
                               const void* viewmatrix, const void* tanfovx,
                               const void* tanfovy, const void* depth, const void* color,
                               int width, int height, float sdf_trunc, float depth_trunc,
                               void* tsdf, void* weight, void* colors, void* live_bricks,
                               void* stream) {
  if (res <= 0 || width <= 0 || height <= 0 || brick_log2 < 0 || brick_log2 > 4 ||
      lattice_log2 < 0 || lattice_log2 > 2 || res > 46340)
    return (int)cudaErrorInvalidValue;
  Grid g;
  g.contracted = contracted ? 1 : 0;
  g.res = res;
  g.base[0] = base_x;
  g.base[1] = base_y;
  g.base[2] = base_z;
  g.scale = scale;
  g.step = 4.0 / (double)res;  // as Python's 4.0 / res
  Layout lay;
  lay.brick_log2 = brick_log2;
  lay.lattice_log2 = lattice_log2;
  lay.bricks = (res + (1 << brick_log2) - 1) >> brick_log2;
  const unsigned side = (unsigned)((lay.bricks + (1 << lattice_log2) - 1) >> lattice_log2);
  if (side > 65535u) return (int)cudaErrorInvalidValue;
  const dim3 grid(side, side, side);
  tsdf_fuse_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      g, lay, (const float*)viewmatrix, (const float*)tanfovx, (const float*)tanfovy,
      (const float*)depth, (const float*)color, width, height, sdf_trunc, depth_trunc,
      (float*)tsdf, (float*)weight, (float*)colors, (unsigned long long*)live_bricks);
  return (int)cudaGetLastError();
}
