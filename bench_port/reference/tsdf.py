"""Plain TSDF fusion of one view into voxels given by their flat index
(plain PyTorch; nothing of the program). The grid and the arithmetic are
the configuration's (`mesh` and `precision` of
configs/mipnerf360-room-2dgs-mesh1024.json):

- a voxel (i, j, k) of an R^3 grid has flat index (i R + j) R + k;
- contracted grid: c = (idx + 0.5) * 4 / R - 2 per axis, pulled onto the
  shell |c| = 1.98 where |c| >= 1.98, then uncontracted (c where |c| <= 1,
  else c / (s (2 - s)), s = |c| clipped to [1e-9, 2 - 1e-6]), times the
  scene's radius plus its centre; |c| = sqrt((x^2 + y^2) + z^2). Bounded
  grid: (idx + 0.5) * voxel size + origin. In float64, rounded to float32;
- the view: p_view = W2C p_world in float32, each row's four terms summed
  pairwise; u = (x / z) fx + cx and v likewise, fx = W / (2 tan(fovx / 2));
- the depth and colour at (u, v): the four bilinear taps;
- the voxel counts where z > 1e-4, (u, v) lies in the image, the depth d
  satisfies 1e-4 < d < depth_trunc and sdf = (d - z) / sdf_trunc > -1;
  then weight += 1, and tsdf and colour become the weighted running average
  with the sdf clamped to [-1, 1] (the old weight over max(weight + 1,
  1e-8)).

Every multiply-add of the taps, the projection's (x / z) fx + cx and the
running average's old value x old weight + new value is rounded once to
float32: a float64 product (exact) plus a float64 add, as the JAX
package's CPU code contracts them; every other operation in float32.
Matrix products are left out (TF32 could take them), and `masks` runs
with TF32 off all the same.
"""

from __future__ import annotations

import torch

from .raster3d import tf32_off

# voxels a block of the whole-grid passes (`counts`, `valid_indices`): ~1 GB
# of temporaries, small beside the grid, so a run's memory peak stays the
# program's
BLOCK = 1 << 23


def grid_of(mesh: dict, radius: float) -> dict:
    """The configuration's grid at the scene's radius: kind, R, centre (or
    origin), scale (the radius, or the voxel size), sdf_trunc and
    depth_trunc in world units."""
    res = int(mesh["mesh_res"])
    if mesh["grid"] == "contracted":
        return dict(kind="contracted", res=res, base=[float(c) for c in mesh["center"]],
                    scale=float(radius),
                    sdf_trunc=float(mesh["sdf_trunc_voxels"]) * (4.0 / res) * radius,
                    depth_trunc=float(mesh["depth_trunc_radii"]) * radius)
    raise ValueError(f"no reference for grid {mesh['grid']!r}")


def _square_gap(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """|x - c^2| for float64 c and x, with c^2 taken exactly as a sum of two
    doubles (Dekker's product of Veltkamp halves)."""
    t = 134217729.0 * c  # 2^27 + 1
    hi = t - (t - c)
    lo = c - hi
    p = c * c
    err = ((hi * hi - p) + (2.0 * hi) * lo) + lo * lo
    return ((x - p) - err).abs()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded to the nearest, as numpy's and CUDA's are. PyTorch's
    float64 sqrt on the CPU lands a unit in the last place off in about one
    case in 200, so there the neighbour whose square is nearest x is taken."""
    r = x.sqrt()
    if x.device.type != "cpu" or x.dtype != torch.float64:
        return r
    for c in (torch.nextafter(r, torch.zeros_like(r)), torch.nextafter(r, r + 1.0)):
        r = torch.where(_square_gap(c, x) < _square_gap(r, x), c, r)
    return r


def voxel_centres(index: torch.Tensor, grid: dict, dtype=torch.float64) -> torch.Tensor:
    """[K, 3] float32 world centres of the voxels of flat `index` [K] (int64),
    computed in `dtype` (float64 as the configuration states; the control
    passes float32)."""
    res = int(grid["res"])
    ijk = torch.stack([index // (res * res), (index // res) % res, index % res], -1).to(dtype)
    base = torch.tensor(grid["base"], dtype=dtype, device=index.device)
    if grid["kind"] == "bounded":
        return ((ijk + 0.5) * grid["scale"] + base).to(torch.float32)

    def norm(c):
        return _sqrt((c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]) + c[:, 2] * c[:, 2])[:, None]

    c = (ijk + 0.5) * (4.0 / res) - 2.0
    n = norm(c)
    # a tensor over a tensor: PyTorch takes a Python number over a tensor as
    # a reciprocal times the number, two roundings
    shell = torch.tensor(1.98, dtype=dtype, device=index.device) / n.clamp_min(1e-9)
    c = torch.where(n >= 1.98, c * shell, c)
    n = norm(c)
    s = n.clamp(1e-9, 2.0 - 1e-6)
    world = torch.where(n <= 1.0, c, c / (s * (2.0 - s)))
    return (world * grid["scale"] + base).to(torch.float32)


def _mad(a, b, c):
    """a * b + c rounded once to float32 (float64 product and add)."""
    return (a.double() * b.double() + c.double()).float()


def project(centres: torch.Tensor, cam: dict) -> dict:
    """Each voxel's view depth z, image position (u, v) and whether it is
    in front of the camera and inside the image."""
    view = cam["view"]  # W2C, [4, 4]
    x, y, zw = centres.unbind(1)

    def row(r):
        return (x * view[r, 0] + y * view[r, 1]) + (zw * view[r, 2] + view[r, 3])

    w, h = cam["width"], cam["height"]
    fx = torch.tensor(w / (2.0 * float(cam["tanx"])), dtype=torch.float32, device=x.device)
    fy = torch.tensor(h / (2.0 * float(cam["tany"])), dtype=torch.float32, device=x.device)
    z = row(2)
    front = z > 1e-4
    zs = torch.where(front, z, torch.ones_like(z))
    u = _mad(row(0) / zs, fx, torch.tensor(w * 0.5 - 0.5, device=x.device))
    v = _mad(row(1) / zs, fy, torch.tensor(h * 0.5 - 0.5, device=x.device))
    inside = front & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    return dict(z=z, u=u, v=v, inside=inside)


def _taps(p: dict, w: int, h: int):
    u = p["u"].clamp(0, w - 1)
    v = p["v"].clamp(0, h - 1)
    u0, v0 = u.floor().long(), v.floor().long()
    u1, v1 = (u0 + 1).clamp_max(w - 1), (v0 + 1).clamp_max(h - 1)
    au, av = u - u0.float(), v - v0.float()

    def sample(plane):  # flat [H * W] -> [K]
        s = _mad(plane[v0 * w + u0] * (1 - au), 1 - av, plane[v0 * w + u1] * au * (1 - av))
        s = _mad(plane[v1 * w + u0] * (1 - au), av, s)
        return _mad(plane[v1 * w + u1] * au, av, s)

    return sample


def masks(centres: torch.Tensor, depth: torch.Tensor, cam: dict, grid: dict) -> dict:
    """inside (in front and in the image), valid (counted by the update) and
    the clamped sdf of each voxel for one view's depth map [H, W]."""
    with tf32_off():
        p = project(centres, cam)
        w, h = cam["width"], cam["height"]
        sample = _taps(p, w, h)
        d = sample(depth.reshape(-1))
        trunc = torch.tensor(grid["sdf_trunc"], dtype=torch.float32, device=d.device)
        dtrunc = torch.tensor(grid["depth_trunc"], dtype=torch.float32, device=d.device)
        sdf = (d - p["z"]) / trunc
        valid = p["inside"] & (d > 1e-4) & (d < dtrunc) & (sdf > -1.0)
    return dict(inside=p["inside"], valid=valid, sdf=sdf.clamp(-1.0, 1.0), sample=sample)


def update(before: dict, centres: torch.Tensor, depth: torch.Tensor, color: torch.Tensor,
           cam: dict, grid: dict) -> dict:
    """The voxels' tsdf [K], weight [K] and colors [K, 3] after one view
    (depth [H, W], color [3, H, W]), from their values `before`."""
    m = masks(centres, depth, cam, grid)
    valid, w = m["valid"], before["weight"]
    w_tot = w + valid.float()
    w_safe = w_tot.clamp_min(1e-8)
    tsdf = torch.where(valid, _mad(before["tsdf"], w, m["sdf"]) / w_safe, before["tsdf"])
    flat = color.reshape(3, -1)
    c = torch.stack([m["sample"](flat[i]) for i in range(3)], -1)
    colors = torch.where(valid[:, None], _mad(before["colors"], w[:, None], c) / w_safe[:, None],
                         before["colors"])
    return dict(tsdf=tsdf, weight=w_tot, colors=colors, valid=valid)


def _blocks(grid: dict, device):
    """(first index, centres [B, 3]) of the whole grid, BLOCK voxels at a
    time."""
    total = int(grid["res"]) ** 3
    for start in range(0, total, BLOCK):
        index = torch.arange(start, min(start + BLOCK, total), device=device)
        yield start, voxel_centres(index, grid)


def counts(grid: dict, views: list) -> list:
    """[(voxels inside the image, valid voxels)] of each (depth [H, W], cam)
    in `views` over the whole grid, in blocks of voxels: each block's
    centres are made once for every view."""
    out = [[0, 0] for _ in views]
    dev = views[0][0].device if views else torch.device("cpu")
    for _, centres in _blocks(grid, dev):
        for acc, (depth, cam) in zip(out, views):
            m = masks(centres, depth, cam, grid)
            acc[0] += int(m["inside"].sum())
            acc[1] += int(m["valid"].sum())
    return [tuple(a) for a in out]


def valid_indices(grid: dict, depth: torch.Tensor, cam: dict) -> torch.Tensor:
    """The flat indices [V] (int64) of the voxels one view's update counts."""
    found = [start + masks(centres, depth, cam, grid)["valid"].nonzero()[:, 0]
             for start, centres in _blocks(grid, depth.device)]
    return torch.cat(found)
