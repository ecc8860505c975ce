// Kernel T: one view's TSDF update of a dense voxel grid, in place, one
// thread a voxel. Each thread makes its voxel's world centre from its index,
// projects it into the view, takes the four bilinear taps of the depth map
// and, where the voxel is valid, of the three colour planes, and updates the
// truncated running average of tsdf, weight and colour.
//
// Replaces no TPU kernel: the JAX package's TSDF update
// (scorp_tpu/pipeline/mesh.py) is plain jitted XLA over a voxel array that
// the host builds. Its plain PyTorch version (scorp_tpu_torch/pipeline/
// mesh.py:_tsdf_update) allocates dozens of grid-sized temporaries a view,
// and the contracted grid's coordinates are an [R^3, 3] array; at the 2DGS
// reference code's unbounded resolution (1024^3) neither fits the card. The
// wrapper: scorp_tpu_torch/ops/tsdf.py; pipeline/mesh.py:TsdfVolume calls
// it for every view on the card.
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
// Numerics: _tsdf_update's operations in its order, built with -fmad=false:
// the projection's four terms summed pairwise, (x a + y b) + (z c + d); each
// of its multiply-adds that XLA's CPU code contracts (_fma) as a float64
// product (exact) plus a float64 add, rounded once to f32 (fma64); every
// other operation in f32. A voxel that is behind the camera, outside the
// image or not valid is left as it is: the plain version writes it back
// unchanged (its weight gains +0), so skipping it writes the same grid.
//
// What bounds it on an H100: the arithmetic of the voxel centres. Every
// voxel of the grid pays its centre (in the contracted grid two float64
// square roots, two divisions and ~30 more float64 operations) and its
// projection each view, at ~1/64 of the card's f32 rate in float64; only
// voxels in the image read the depth taps, and only valid ones the colour
// taps and their 20 bytes of state. The least bytes a view needs are those
// valid voxels' state read and written (40 B each) and the two maps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  int contracted;   // 0: bounded, 1: contracted
  int64_t res;      // R
  double base[3];   // bounded: origin; contracted: the scene's centre
  double scale;     // bounded: voxel size; contracted: scale_radius
  double step;      // contracted: 4 / R
};

// a * b + c: the f32 product exact in float64, the sum rounded to float64
// and then to f32, as _fma does it.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn((double)a * (double)b + (double)c);
}

__device__ __forceinline__ double norm3(const double p[3]) {
  return sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]);
}

__device__ __forceinline__ void voxel_centre(const Grid& g, int64_t n, float out[3]) {
  const int64_t idx[3] = {n / (g.res * g.res), (n / g.res) % g.res, n % g.res};
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

__global__ void __launch_bounds__(kThreads)
tsdf_fuse_kernel(Grid g, int64_t m, const float* __restrict__ vm,
                 const float* __restrict__ tanfovx, const float* __restrict__ tanfovy,
                 const float* __restrict__ depth, const float* __restrict__ color, int width,
                 int height, float sdf_trunc, float depth_trunc, float* __restrict__ tsdf,
                 float* __restrict__ weight, float* __restrict__ colors) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= m) return;
  float p[3];
  voxel_centre(g, n, p);
  const float x = p[0], y = p[1], zw = p[2];
  // [x, y, z, 1] @ view_t[:, c]
  const float z = (x * vm[2] + y * vm[6]) + (zw * vm[10] + vm[14]);
  if (!(z > 1e-4f)) return;
  const float fx = __double2float_rn((double)width / (2.0 * (double)*tanfovx));
  const float fy = __double2float_rn((double)height / (2.0 * (double)*tanfovy));
  const float cx = __double2float_rn((double)width * 0.5 - 0.5);
  const float cy = __double2float_rn((double)height * 0.5 - 0.5);
  const float vx = (x * vm[0] + y * vm[4]) + (zw * vm[8] + vm[12]);
  const float vy = (x * vm[1] + y * vm[5]) + (zw * vm[9] + vm[13]);
  const float u = fma64(vx / z, fx, cx);
  const float v = fma64(vy / z, fy, cy);
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
  const float w = weight[n];
  const float w_tot = w + 1.0f;
  const float w_safe = fmaxf(w_tot, 1e-8f);
  tsdf[n] = fma64(tsdf[n], w, sdf) / w_safe;
  weight[n] = w_tot;
  const int64_t plane = (int64_t)width * height;
  float* c = colors + 3 * n;
  for (int ch = 0; ch < 3; ++ch) {
    const float s = sample(color + ch * plane, i00, i01, i10, i11, au, av);
    c[ch] = fma64(c[ch], w, s) / w_safe;
  }
}

}  // namespace

extern "C" int scorp_tsdf_fuse(int contracted, int res, double base_x, double base_y,
                               double base_z, double scale, const void* viewmatrix,
                               const void* tanfovx, const void* tanfovy, const void* depth,
                               const void* color, int width, int height, float sdf_trunc,
                               float depth_trunc,
                               void* tsdf, void* weight, void* colors, void* stream) {
  if (res <= 0 || width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  Grid g;
  g.contracted = contracted ? 1 : 0;
  g.res = res;
  g.base[0] = base_x;
  g.base[1] = base_y;
  g.base[2] = base_z;
  g.scale = scale;
  g.step = 4.0 / (double)res;  // as Python's 4.0 / res
  const int64_t m = (int64_t)res * res * res;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tsdf_fuse_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, m, (const float*)viewmatrix, (const float*)tanfovx, (const float*)tanfovy,
      (const float*)depth, (const float*)color, width, height, sdf_trunc, depth_trunc,
      (float*)tsdf, (float*)weight, (float*)colors);
  return (int)cudaGetLastError();
}
