"""Mesh extraction from a trained 2DGS model, port of
`scorp_tpu.pipeline.mesh`.

Render the training views, TSDF-fuse their depth maps into a voxel grid,
extract a triangle mesh. The grid is a `TsdfVolume`: tsdf, weight and
colour of every voxel on the grid's device, its voxels described by the
grid's kind (bounded: an axis-aligned box; contracted: the mip-NeRF-360
contraction of the whole unbounded scene into [-2, 2]^3) and never stored
as coordinates. Each view is one update of the whole grid: every voxel
projects into the view's depth and colour images and takes a bilinear
sample, with the truncated-SDF weighted running average (voxel 0.004 /
sdf_trunc 0.02 / depth_trunc 3 defaults). On the card the update is kernel
T (`ops/tsdf.py`), one launch a view; elsewhere it is the plain
`_tsdf_update` over blocks of voxel centres. The update is written out
element by element (no matmul, no fused op of PyTorch's choosing), so the
grid is the same bit for bit on the CPU and on the card.

`TsdfVolume.triangulate` makes the mesh. Marching cubes
(`pipeline/marching_cubes.py`) runs on the grid's own device: on the card
it is kernel M (`ops/marching_cubes.py`), which also maps the vertices to
world coordinates there in float64, and only the mesh is copied to the
host; on the CPU the plain function runs a slab of planes at a time. Both
give the same mesh bit for bit, and neither builds an array of the grid's
size. Naive surface nets (one vertex per sign-change cell), kept as an
alternative, runs on the host over a copy of the grid.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.camera import Camera
from ..device import resolve_device
from ..ops.marching_cubes import marching_cubes as marching_cubes_kernel
from ..ops.tsdf import tsdf_fuse as tsdf_fuse_kernel
from ..utils.trace import span

GRID_KINDS = ("bounded", "contracted")
# voxels a block of the plain update: ~40 f32 and int64 temporaries of
# this length, a few hundred MB
PLAIN_BLOCK = 1 << 20
# counters: the vertices and faces of every mesh `TsdfVolume.triangulate`
# made, summed over calls (host ints: on the card, kernel M's totals)
vertices = 0
faces = 0


def _f32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _fma(a, b, c):
    """a * b + c in f32 with one rounding (the product is exact in float64),
    as XLA's CPU code contracts it."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _tsdf_update(tsdf, weight, color_acc, voxels, depth_img, color_img, view_t,
                 fx, fy, cx, cy, sdf_trunc, depth_trunc, width: int, height: int):
    """One view's update of the flat grid (tsdf [M], weight [M], colours
    [M, 3]). `voxels` is (x, y, z), world coordinates that broadcast to the
    grid's shape; `view_t` is W2C^T (row-vector convention); the scalars are
    0-d f32 tensors on the grid's device.

    The arithmetic is the JAX package's as XLA compiles it for the CPU: the
    4-term projection summed pairwise, and a multiply feeding an add fused
    (`_fma`) where XLA fuses it. A silhouette pixel's depth changes by the
    object's whole depth across one pixel, so one ulp in u moves the
    sampled depth, and the TSDF, by far more than one ulp."""
    dev = tsdf.device
    x, y, z_w = voxels

    def view(c):  # [x, y, z, 1] @ view_t[:, c]
        return ((x * view_t[0, c] + y * view_t[1, c])
                + (z_w * view_t[2, c] + view_t[3, c])).reshape(-1)

    z = view(2)
    in_front = z > _f32(1e-4, dev)
    zs = torch.where(in_front, z, _f32(1.0, dev))
    u = _fma(view(0) / zs, fx, cx)
    v = _fma(view(1) / zs, fy, cy)
    inside = in_front & (u >= 0) & (u <= width - 1) & (v >= 0) & (v <= height - 1)

    ui = torch.clamp(u, 0, width - 1)
    vi = torch.clamp(v, 0, height - 1)
    u0 = torch.floor(ui).to(torch.int64)
    v0 = torch.floor(vi).to(torch.int64)
    u1 = torch.clamp_max(u0 + 1, width - 1)
    v1 = torch.clamp_max(v0 + 1, height - 1)
    au = ui - u0.to(torch.float32)
    av = vi - v0.to(torch.float32)
    i00, i01 = v0 * width + u0, v0 * width + u1
    i10, i11 = v1 * width + u0, v1 * width + u1

    def sample(img):  # flat [H*W] -> [M]: the four bilinear taps
        s = _fma(img[i00] * (1 - au), 1 - av, img[i01] * au * (1 - av))
        s = _fma(img[i10] * (1 - au), av, s)
        return _fma(img[i11] * au, av, s)

    d = sample(depth_img.reshape(-1))
    valid = inside & (d > _f32(1e-4, dev)) & (d < depth_trunc)
    sdf = (d - z) / sdf_trunc
    valid = valid & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)

    w_tot = weight + valid.to(torch.float32)
    w_safe = torch.clamp_min(w_tot, _f32(1e-8, dev))
    tsdf = torch.where(valid, _fma(tsdf, weight, sdf) / w_safe, tsdf)
    flat = color_img.reshape(3, -1)
    c = torch.stack([sample(flat[i]) for i in range(3)], dim=-1)
    color_acc = torch.where(valid[:, None],
                            _fma(color_acc, weight[:, None], c) / w_safe[:, None], color_acc)
    return tsdf, w_tot, color_acc


def _voxel_centres(kind: str, res: int, base, scale: float, start: int,
                   stop: int) -> np.ndarray:
    """[stop - start, 3] f32 world centres of the flat voxels start..stop-1
    (index (i R + j) R + k) of an R^3 grid, made in float64 and rounded
    once. bounded: (idx + 0.5) * scale + base per axis (base the origin,
    scale the voxel size). contracted: (idx + 0.5) * step - 2 with step =
    4 / R, the outer shell pulled inside the invertible region (|c| = 1.98),
    uncontracted, times scale (the scene's radius) plus base (its centre)."""
    n = np.arange(start, stop, dtype=np.int64)
    ijk = np.stack([n // (res * res), (n // res) % res, n % res], -1)
    if kind == "bounded":
        world = (ijk + 0.5) * scale + np.asarray(base, np.float64)
    else:
        contracted = (ijk + 0.5) * (4.0 / res) - 2.0
        cnorm = np.linalg.norm(contracted, axis=-1, keepdims=True)
        contracted = np.where(cnorm >= 1.98,
                              contracted * (1.98 / np.maximum(cnorm, 1e-9)), contracted)
        world = uncontract(contracted) * scale + np.asarray(base, np.float64)
    return world.astype(np.float32)


class TsdfVolume:
    """A dense R^3 TSDF grid on one device: `tsdf` [R^3] (ones), `weight`
    [R^3] (zeros) and `colors` [R^3, 3] (zeros), f32, flat in the order
    (i R + j) R + k; 20 bytes a voxel. The voxels are described by `kind`,
    `res`, `base` and `scale` (see `_voxel_centres`) and are never
    materialised. `integrate` fuses one view."""

    def __init__(self, kind: str, res: int, base, scale: float, sdf_trunc: float,
                 depth_trunc: float, device: str | torch.device = "cuda"):
        if kind not in GRID_KINDS:
            raise ValueError(f"grid kind {kind!r} is not one of {GRID_KINDS}")
        self.kind, self.res = kind, int(res)
        self.base = np.asarray(base, np.float64).reshape(3)
        self.scale = float(scale)
        self.step = 4.0 / self.res
        self.sdf_trunc, self.depth_trunc = float(sdf_trunc), float(depth_trunc)
        self.device = resolve_device(device)
        self.tsdf = torch.ones(self.voxels, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(self.voxels, dtype=torch.float32, device=self.device)
        self.colors = torch.zeros((self.voxels, 3), dtype=torch.float32, device=self.device)

    @classmethod
    def bounded(cls, center, extent: float, voxel_size: float, sdf_trunc: float,
                depth_trunc: float, max_resolution: int,
                device: str | torch.device) -> "TsdfVolume":
        """The box center +- extent at voxel_size, at most max_resolution
        voxels a side (the voxel size then grows to fit)."""
        res = min(max_resolution, int(np.ceil(2 * extent / voxel_size)))
        voxel_size = 2 * extent / res
        return cls("bounded", res, np.asarray(center) - extent, voxel_size,
                   sdf_trunc / voxel_size * voxel_size, depth_trunc, device)

    @classmethod
    def contracted(cls, center, scale_radius: float, resolution: int, sdf_trunc_vox: float,
                   depth_trunc: float, device: str | torch.device) -> "TsdfVolume":
        """The whole unbounded scene, contracted around `center` at
        `scale_radius` into [-2, 2]^3 at `resolution` voxels a side; the
        truncation is sdf_trunc_vox voxels of the contracted grid, in world
        units at the radius."""
        step = 4.0 / resolution
        return cls("contracted", resolution, center, scale_radius,
                   sdf_trunc_vox * step * scale_radius, depth_trunc, device)

    @property
    def voxels(self) -> int:
        return self.res ** 3

    def integrate(self, depth: torch.Tensor, color: torch.Tensor, cam: Camera) -> None:
        """Fuse one view: depth [H, W] and color [3, H, W] (f32, on the
        grid's device) seen by `cam`. Kernel T on the card; the plain
        update in blocks elsewhere."""
        with span("mesh.fuse"):
            if self.device.type == "cuda":
                tsdf_fuse_kernel(self.tsdf, self.weight, self.colors, depth, color, cam,
                                 contracted=self.kind == "contracted", res=self.res,
                                 base=self.base, scale=self.scale,
                                 sdf_trunc=self.sdf_trunc, depth_trunc=self.depth_trunc)
            else:
                self.integrate_plain(depth, color, cam)

    def integrate_plain(self, depth: torch.Tensor, color: torch.Tensor, cam: Camera) -> None:
        """`integrate` by the plain `_tsdf_update`, PLAIN_BLOCK voxels at a
        time, on any device (the CPU's path; on the card the kernel's
        yardstick)."""
        dev = self.device
        w, h = cam.width, cam.height
        fx = w / (2.0 * float(cam.tanfovx))
        fy = h / (2.0 * float(cam.tanfovy))
        scalars = [_f32(v, dev) for v in (fx, fy, w * 0.5 - 0.5, h * 0.5 - 0.5,
                                          self.sdf_trunc, self.depth_trunc)]
        for start in range(0, self.voxels, PLAIN_BLOCK):
            sl = slice(start, min(start + PLAIN_BLOCK, self.voxels))
            xyz = torch.as_tensor(_voxel_centres(self.kind, self.res, self.base, self.scale,
                                                 sl.start, sl.stop), device=dev)
            self.tsdf[sl], self.weight[sl], self.colors[sl] = _tsdf_update(
                self.tsdf[sl], self.weight[sl], self.colors[sl], xyz.unbind(1), depth, color,
                cam.viewmatrix, *scalars, width=w, height=h)

    def grids(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tsdf [R, R, R], weight [R, R, R], colors [R, R, R, 3]) on the
        host (views of the grid on the CPU, copies from any other device)."""
        shape = (self.res,) * 3
        return (self.tsdf.cpu().numpy().reshape(shape), self.weight.cpu().numpy().reshape(shape),
                self.colors.cpu().numpy().reshape(shape + (3,)))

    def triangulate(self, method: str = "marching_cubes"):
        """The grid's mesh on the host: (vertices [V, 3] float64 in world
        coordinates, faces [F, 3] int64, colours [V, 3] float64). Grid
        coordinates p map to (p + 0.5) * scale + base (bounded) or to
        uncontract((p + 0.5) * step - 2) * scale + base (contracted).
        Marching cubes on the card is kernel M, the map included (span
        `mesh.triangulate`), then one copy of the three arrays to page-locked
        host memory (span `mesh.to_host`); elsewhere, and for surface nets,
        the host functions of the module run on the grid's host arrays."""
        global vertices, faces
        contracted = self.kind == "contracted"
        origin, vs = (np.full(3, -2.0), self.step) if contracted else (self.base, self.scale)
        if method == "marching_cubes" and self.device.type == "cuda":
            with span("mesh.triangulate"):
                mesh = marching_cubes_kernel(
                    self.tsdf, self.weight, self.colors, (self.res,) * 3, origin=origin,
                    voxel_size=vs, contract=(self.scale, self.base) if contracted else None)
            with span("mesh.to_host"):
                # page-locked buffers from PyTorch's caching host allocator: a
                # buffer goes back to the cache when its array is dropped, so
                # later calls copy at the link's rate without pinning anew
                # (a pageable copy of a room's 1024^3 mesh ran at ~1.8 GB/s)
                host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in mesh]
                for h, a in zip(host, mesh):
                    h.copy_(a, non_blocking=True)
                with span("sync.mesh_copy"):
                    torch.cuda.current_stream(self.device).synchronize()
                verts, tris, cols = (h.numpy() for h in host)
        else:
            with span("mesh.triangulate"):
                tsdf, weight, colors = self.grids()
                verts, tris, cols = _triangulate(method)(tsdf, weight, origin, vs, colors)
                if contracted:
                    verts = uncontract(verts) * self.scale + self.base
        vertices += len(verts)
        faces += len(tris)
        return verts, tris, cols


def _fuse(render_fn, cameras, volume: TsdfVolume) -> None:
    """Render every camera and fuse its depth and colour into `volume`."""
    dev = volume.device
    for cam in cameras:
        pkg = render_fn(cam)
        depth = torch.as_tensor(pkg["render_depth"], device=dev)[0].to(torch.float32)
        color = torch.as_tensor(pkg["render"], device=dev).to(torch.float32)
        volume.integrate(depth.contiguous(), color.contiguous(), cam.to_torch(dev))


def tsdf_fuse(
    render_fn,
    cameras,
    center: np.ndarray,
    extent: float,
    voxel_size: float = 0.004,
    sdf_trunc: float = 0.02,
    depth_trunc: float = 3.0,
    max_resolution: int = 256,
    device: str | torch.device = "cuda",
):
    """Fuse rendered depth maps into a TSDF grid on `device`.

    render_fn(camera) -> dict with 'render' [3,H,W] and 'render_depth'
    [1,H,W] (tensors or arrays). Returns (tsdf [R,R,R], weights, colors
    [R,R,R,3], origin, voxel_size) on the host."""
    volume = fuse_bounded(render_fn, cameras, center, extent, voxel_size, sdf_trunc,
                          depth_trunc, max_resolution, device=device)
    return (*volume.grids(), volume.base, volume.scale)


def fuse_bounded(render_fn, cameras, center, extent, voxel_size, sdf_trunc, depth_trunc,
                 max_resolution, device) -> TsdfVolume:
    """`tsdf_fuse`'s grid (a `TsdfVolume` on `device`) after every view."""
    volume = TsdfVolume.bounded(center, extent, voxel_size, sdf_trunc, depth_trunc,
                                max_resolution, device=device)
    _fuse(render_fn, cameras, volume)
    return volume


def surface_nets(tsdf: np.ndarray, weight: np.ndarray, origin, voxel_size,
                 colors: np.ndarray | None = None):
    """Naive surface nets over a TSDF grid -> (vertices, faces, vert_colors)."""
    observed = weight > 0
    sdf = np.where(observed, tsdf, np.nan)

    # cells with a sign change across any of their 8 corners
    def corners(a):
        return np.stack([
            a[:-1, :-1, :-1], a[1:, :-1, :-1], a[:-1, 1:, :-1], a[1:, 1:, :-1],
            a[:-1, :-1, 1:], a[1:, :-1, 1:], a[:-1, 1:, 1:], a[1:, 1:, 1:],
        ], axis=-1)

    c = corners(sdf)
    all_obs = ~np.isnan(c).any(axis=-1)
    has_pos = (c > 0).any(axis=-1)
    has_neg = (c < 0).any(axis=-1)
    active = all_obs & has_pos & has_neg
    if not active.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), np.zeros((0, 3))

    cell_index = -np.ones(active.shape, np.int64)
    ci, cj, ck = np.nonzero(active)
    cell_index[ci, cj, ck] = np.arange(len(ci))

    # vertex per active cell: centroid of zero crossings on its edges
    corner_offsets = np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
    ], float)
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    vals = c[ci, cj, ck]                       # [A, 8]
    base = np.stack([ci, cj, ck], axis=-1).astype(float)
    verts = np.zeros((len(ci), 3))
    counts = np.zeros(len(ci))
    for a, b in edges:
        va, vb = vals[:, a], vals[:, b]
        crossing = (va > 0) != (vb > 0)
        t = np.where(crossing, va / np.where(va - vb == 0, 1.0, va - vb), 0.0)
        point = corner_offsets[a] + t[:, None] * (corner_offsets[b] - corner_offsets[a])
        verts += np.where(crossing[:, None], point, 0.0)
        counts += crossing
    verts = base + verts / np.maximum(counts, 1)[:, None]
    vertices = (verts + 0.5) * voxel_size + origin

    # faces: for each grid edge crossing the surface, connect the 4 cells
    # sharing it (two triangles), oriented by the sign of the first corner
    faces = []
    for axis in range(3):
        shift = [0, 0, 0]
        shift[axis] = 1
        a = sdf[1:-1, 1:-1, 1:-1]
        b = sdf[1 + shift[0]:sdf.shape[0] - 1 + shift[0],
                1 + shift[1]:sdf.shape[1] - 1 + shift[1],
                1 + shift[2]:sdf.shape[2] - 1 + shift[2]]
        cross = (~np.isnan(a)) & (~np.isnan(b)) & ((a > 0) != (b > 0))
        xi, yi, zi = np.nonzero(cross)
        xi, yi, zi = xi + 1, yi + 1, zi + 1
        # the 4 cells around this edge (perpendicular axes)
        ax1, ax2 = [(1, 2), (0, 2), (0, 1)][axis]
        quads = []
        for d1 in (0, 1):
            for d2 in (0, 1):
                off = [0, 0, 0]
                off[ax1] = -d1
                off[ax2] = -d2
                quads.append(cell_index[xi + off[0], yi + off[1], zi + off[2]])
        q00, q01, q10, q11 = quads
        ok = (q00 >= 0) & (q01 >= 0) & (q10 >= 0) & (q11 >= 0)
        flip = a[xi - 1, yi - 1, zi - 1] > 0
        sel = np.nonzero(ok)[0]
        v = np.stack([q00[sel], q01[sel], q11[sel], q10[sel]], 1)
        f = flip[sel][:, None, None]
        pos = np.stack([v[:, [0, 1, 2]], v[:, [0, 2, 3]]], 1)
        neg = np.stack([v[:, [0, 2, 1]], v[:, [0, 3, 2]]], 1)
        faces.append(np.where(f, pos, neg).reshape(-1, 3))
    faces = np.concatenate(faces).astype(np.int64)

    if colors is not None:
        vert_colors = colors[ci, cj, ck]
    else:
        vert_colors = np.zeros((len(ci), 3))
    return vertices, faces, vert_colors


def post_process_mesh(vertices: np.ndarray, faces: np.ndarray,
                      colors: np.ndarray | None = None,
                      cluster_to_keep: int = 1000):
    """Filter out floaters: cluster triangles connected via shared edges,
    keep clusters with at least max(size of the `cluster_to_keep`-th largest
    cluster, 50) triangles, then drop degenerate triangles and unreferenced
    vertices. Returns the filtered (vertices, faces, colors).

    The clusters are the connected components of the shared-edge graph
    (scipy's `connected_components`, where the JAX package runs a Python
    union-find): the same sizes, so the same faces are kept, in order.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    n_raw = len(vertices)
    if len(faces) == 0:
        return vertices[:0], faces, (None if colors is None else
                                     np.asarray(colors)[:0])

    # --- connected triangle clusters (edge adjacency) ---
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], 0)
    e = np.sort(e, axis=1)
    tri = np.tile(np.arange(len(faces)), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, tri = e[order], tri[order]
    k = np.nonzero((e[1:] == e[:-1]).all(axis=1))[0]  # consecutive rows = same edge
    graph = coo_matrix((np.ones(len(k), np.int8), (tri[k], tri[k + 1])),
                       shape=(len(faces), len(faces)))
    _, labels = connected_components(graph, directed=False)
    counts = np.bincount(labels)

    # threshold: size of the cluster_to_keep-th largest cluster, floored at 50
    kth = np.sort(counts)[-min(int(cluster_to_keep), len(counts))]
    thresh = max(int(kth), 50)
    faces = faces[counts[labels] >= thresh]

    # remove degenerate triangles (repeated vertex indices)
    nondegen = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                & (faces[:, 0] != faces[:, 2]))
    faces = faces[nondegen]

    # remove unreferenced vertices
    used = np.unique(faces)
    remap = np.full(n_raw, -1, np.int64)
    remap[used] = np.arange(len(used))
    faces = remap[faces]
    vertices = vertices[used]
    if colors is not None:
        colors = np.asarray(colors)[used]
    return vertices, faces, colors


def save_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                  colors: np.ndarray | None = None):
    """Binary-LE PLY with vertex + face elements (the JAX package's bytes,
    written as two packed numpy records instead of one struct per row)."""
    n, f = len(vertices), len(faces)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    vfields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        vfields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header += [f"element face {f}", "property list uchar int vertex_indices", "end_header"]
    vrec = np.empty(n, np.dtype(vfields))
    xyz = np.asarray(vertices).reshape(n, 3).astype("<f4")
    for i, name in enumerate("xyz"):
        vrec[name] = xyz[:, i]
    if colors is not None:
        cc = np.clip(np.asarray(colors).reshape(n, 3) * 255, 0, 255).astype(np.uint8)
        for i, name in enumerate(("red", "green", "blue")):
            vrec[name] = cc[:, i]
    frec = np.empty(f, np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")]))
    frec["n"] = 3
    fi = np.asarray(faces).reshape(f, 3)
    for i, name in enumerate("abc"):
        frec[name] = fi[:, i]
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(vrec.tobytes())
        fh.write(frec.tobytes())


class GaussianExtractor:
    """Mesh extraction (the reference GaussianExtractor surface);
    fuses on `device`."""

    def __init__(self, render_fn, cameras, device: str | torch.device = "cuda"):
        self.render_fn = render_fn
        self.cameras = cameras
        self.device = device

    def extract_mesh_bounded(self, center, extent, voxel_size=0.004,
                             sdf_trunc=0.02, depth_trunc=3.0, max_resolution=256,
                             method="marching_cubes"):
        volume = fuse_bounded(self.render_fn, self.cameras, center, extent, voxel_size,
                              sdf_trunc, depth_trunc, max_resolution, device=self.device)
        return volume.triangulate(method)

    def extract_mesh_unbounded(self, center, scale_radius, resolution=256,
                               depth_trunc=1e9, method="marching_cubes"):
        return tsdf_fuse_unbounded(
            self.render_fn, self.cameras, center, scale_radius,
            resolution=resolution, depth_trunc=depth_trunc, method=method,
            device=self.device,
        )


def contract(x: np.ndarray) -> np.ndarray:
    """mip-NeRF-360 space contraction: identity inside the unit ball,
    (2 - 1/|x|)·x/|x| outside (the unbounded TSDF variant)."""
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    safe = np.maximum(norm, 1e-9)
    return np.where(norm <= 1.0, x, (2.0 - 1.0 / safe) * x / safe)


def uncontract(y: np.ndarray) -> np.ndarray:
    """Inverse contraction (valid for |y| < 2)."""
    norm = np.linalg.norm(y, axis=-1, keepdims=True)
    safe = np.clip(norm, 1e-9, 2.0 - 1e-6)
    return np.where(norm <= 1.0, y, y / (safe * (2.0 - safe)))


def _triangulate(method: str):
    if method == "marching_cubes":
        from . import marching_cubes
        return marching_cubes.marching_cubes
    assert method == "surface_nets", method
    return surface_nets


def tsdf_fuse_unbounded(render_fn, cameras, center, scale_radius: float,
                        resolution: int = 256, sdf_trunc_vox: float = 4.0,
                        depth_trunc: float = 1e9, method: str = "marching_cubes",
                        device: str | torch.device = "cuda"):
    """TSDF fusion on a grid defined in CONTRACTED coordinates (covers the
    whole unbounded scene in a [-2, 2]^3 cube): each voxel centre
    uncontracts to world space (in float64) before projecting into the
    depth maps; the mesh's vertices are uncontracted likewise
    (`TsdfVolume.triangulate`)."""
    volume = TsdfVolume.contracted(center, scale_radius, resolution, sdf_trunc_vox,
                                   depth_trunc, device=device)
    _fuse(render_fn, cameras, volume)
    return volume.triangulate(method)
