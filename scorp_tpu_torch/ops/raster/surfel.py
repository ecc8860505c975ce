"""The 2DGS surfel rasterizer's per-surfel stages, torch port of
`scorp_tpu.ops.raster.surfel`.

Each surfel is a 2D Gaussian disc X(u,v) = p + s_u·t_u·u + s_v·t_v·v in
the frame (t_u, t_v, t_n) of its quaternion. `preprocess_surfel` builds the
3x3 splat-UV -> pixel homography M per surfel (columns M0 M1 M2), the view
depth as a linear function of (u, v, 1), the projected centre, the
camera-facing view normal, the colour and a conservative tile rect: the
union of the projected ±c_uv corners of the splat and the low-pass disc
around the centre (not the 3DGS radius).

Per (pixel, key) the compositors (kernels K4-K6, `surfel_composite.py`,
`surfel_backward.py`) evaluate the ray-splat solve as the linear form
s = adj(M)·(px, py, 1) with `surfel_adj`'s normalized adjugate rows, then
u, v = s/s_z (s_z clamped to 1e-9 in magnitude, u and v clipped to ±1e3),
rho = min(u² + v², 2·|c − p|²) and alpha = min(0.99, 2^(−0.5·log2(e)·rho
+ log2 opacity)). The 7-channel allmap: color + T·bg, alpha, Σw·z, Σw·normal,
the median depth (z of the last included key whose entry transmittance
exceeds 0.5) and the distortion Σ w_i (m_i²·A + D2 − 2·m_i·D) over the
prefix sums A, D, D2 of w, w·m, w·m².

Distortion form: this port uses m = FF − (FF·NEAR)/max(z, 1e-6) with
FF = FAR/(FAR − NEAR), the folded form of the JAX package's Pallas kernels,
in the plain versions and in the CUDA kernels alike (the JAX golden keeps
FF·(1 − NEAR/z), about 1 ulp away).

`surfel_cull_ellipses` gives K1 two screen ellipses per surfel, the
UV-disc conic and the low-pass circle; a key is kept iff either admits its
tile. The routing (`common.route_stream`) takes a `SurfelPrep` as it is,
with these two ellipses.

These are the plain stages, which autograd records on the grad path. On
the eval path `fused_surfel_preprocess.preprocess_surfel_kernel` computes
what they give the routing and K4 (`SurfelFrame`) in one CUDA launch;
`surfel_frame_plain` is that bundle by the plain stages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...core import sh as sh_lib
from ...core.camera import Camera
from ...core.quat import quat_to_rotmat
from ...utils.trace import span
from .common import TILE, _tile_index, expected_depth, grid_dims, log2_opacity

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_PLANE = 0.2
FAR_PLANE = 100.0
FILTER_INV_SQUARE = 2.0
FF = FAR_PLANE / (FAR_PLANE - NEAR_PLANE)
FFN = FF * NEAR_PLANE
NC = -0.5 * 1.4426950408889634  # -0.5·log2(e): alpha in one exp2
SURFEL_COLS = 21  # stream columns: adj(M) 9, zrow 3, xy 2, color 3, normal 3, log2 opacity 1


class SurfelPrep(NamedTuple):
    M: torch.Tensor          # [N,3,3] splat-UV -> pixel homogeneous (columns M0 M1 M2)
    zrow: torch.Tensor       # [N,3] view depth as a linear function of (u, v, 1)
    xy: torch.Tensor         # [N,2] projected centers (pixels)
    depth: torch.Tensor      # [N] center view z
    normal: torch.Tensor     # [N,3] view-space normal (camera-facing)
    color: torch.Tensor      # [N,3]
    opacity: torch.Tensor    # [N]
    radii: torch.Tensor      # [N] int32
    rect: torch.Tensor       # [N,4] int32 binning tile rect
    valid: torch.Tensor      # [N] bool


class SurfelOutput(NamedTuple):
    color: torch.Tensor         # [3, H, W]
    alpha: torch.Tensor         # [1, H, W]
    depth_accum: torch.Tensor   # [1, H, W] alpha-weighted expected view depth
    normal: torch.Tensor        # [3, H, W] view-space, alpha-weighted
    depth_median: torch.Tensor  # [1, H, W]
    distortion: torch.Tensor    # [1, H, W]
    radii: torch.Tensor
    num_dropped_keys: torch.Tensor


class SurfelFrame(NamedTuple):
    """What the eval path reads of the per-surfel stages: the routing's
    fields (`xy`, `depth`, `rect`, `valid`), the radii, the [N, 21] stream
    table (`surfel_table`) and K1's two cull ellipses
    (`surfel_cull_ellipses`)."""

    xy: torch.Tensor       # [N,2] projected centers (pixels)
    depth: torch.Tensor    # [N] center view z
    rect: torch.Tensor     # [N,4] int32 binning tile rect
    valid: torch.Tensor    # [N] bool
    radii: torch.Tensor    # [N] int32
    table: torch.Tensor    # [N,21] stream rows
    ell: torch.Tensor      # [N,6] the UV disc's screen conic
    circ: torch.Tensor     # [N,6] the low-pass circle


def _t2(opacity: torch.Tensor) -> torch.Tensor:
    """2·log(255·opacity), floored at 0: the rho below which alpha >= 1/255."""
    return torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-12) * 255.0), 0.0)


def surfel_camera(cam: Camera):
    """(r_w2c, t_w2c, A, b): the world -> view rotation and translation, and
    the world -> (xw, yw, w) map x A^T + b with A = K r_w2c, b = K t_w2c of
    the pinhole K (principal point at the pixel centres' middle)."""
    w, h = cam.width, cam.height
    V = cam.viewmatrix
    dev, dt = V.device, V.dtype
    r_w2c = V[:3, :3].T            # world -> view rotation
    t_w2c = V[3, :3]
    fx = w / (2.0 * cam.tanfovx)
    fy = h / (2.0 * cam.tanfovy)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    K = torch.stack([
        torch.stack([fx, zero, zero + (w * 0.5 - 0.5)]),
        torch.stack([zero, fy, zero + (h * 0.5 - 0.5)]),
        torch.stack([zero, zero, one]),
    ])
    return r_w2c, t_w2c, K @ r_w2c, K @ t_w2c


def preprocess_surfel(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    quats: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_deltas: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> SurfelPrep:
    n = means3d.shape[0]
    w, h = cam.width, cam.height
    tiles_x, tiles_y = grid_dims(w, h)
    dt = means3d.dtype

    r_w2c, t_w2c, A, b = surfel_camera(cam)
    R = quat_to_rotmat(quats)      # [N,3,3] columns t_u, t_v, t_n
    su = scales[:, 0] * scale_modifier
    sv = scales[:, 1] * scale_modifier
    axis_u = R[:, :, 0] * su[:, None]   # [N,3] world
    axis_v = R[:, :, 1] * sv[:, None]
    t_n = R[:, :, 2]

    M0 = axis_u @ A.T              # [N,3] column 0 of M
    M1 = axis_v @ A.T
    M2 = means3d @ A.T + b
    M = torch.stack([M0, M1, M2], dim=-1)  # [N,3,3] columns

    zu = axis_u @ r_w2c.T[:, 2]
    zv = axis_v @ r_w2c.T[:, 2]
    zc = means3d @ r_w2c.T[:, 2] + t_w2c[2]
    zrow = torch.stack([zu, zv, zc], dim=-1)

    in_front = zc > NEAR_PLANE
    w_center = torch.where(M2[:, 2].abs() > 1e-8, M2[:, 2], 1e-8)
    pix_x = M2[:, 0] / w_center
    pix_y = M2[:, 1] / w_center
    if screen_deltas is not None:
        pix_x = pix_x + screen_deltas[:, 0] * (w * 0.5)
        pix_y = pix_y + screen_deltas[:, 1] * (h * 0.5)
    xy = torch.stack([pix_x, pix_y], dim=-1)

    # conservative screen bbox: corners of the ±c(u,v) splat rect projected,
    # unioned with the low-pass disc around the center (integer outputs only)
    opacity = opacities.reshape(n)
    with torch.no_grad():
        t2 = _t2(opacity)
        c_uv = torch.clamp_max(torch.sqrt(t2), 3.0)
        corners = []
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                hom = M2 + c_uv[:, None] * (sx * M0 + sy * M1)
                wc = torch.clamp_min(hom[:, 2], 1e-2)   # clamp behind-camera corners
                corners.append(torch.stack([hom[:, 0] / wc, hom[:, 1] / wc], dim=-1))
        corners = torch.stack(corners, dim=1)          # [N,4,2]
        r_lp = torch.sqrt(t2 / FILTER_INV_SQUARE)
        xy_d = xy.detach()
        lo = torch.minimum(corners.min(dim=1).values, xy_d - r_lp[:, None])
        hi = torch.maximum(corners.max(dim=1).values, xy_d + r_lp[:, None])

        x0 = _tile_index(lo[:, 0] / TILE, tiles_x)
        y0 = _tile_index(lo[:, 1] / TILE, tiles_y)
        x1 = _tile_index((hi[:, 0] + TILE - 1) / TILE, tiles_x)
        y1 = _tile_index((hi[:, 1] + TILE - 1) / TILE, tiles_y)
        valid = in_front & (t2 > 0.0) & (x1 > x0) & (y1 > y0)
        if alive is not None:
            valid = valid & alive
        rect = torch.stack([x0, y0, x1, y1], dim=-1) * valid[:, None].to(torch.int32)

        half_extent = torch.maximum(hi - xy_d, xy_d - lo).max(dim=1).values
        radii = torch.where(valid, torch.ceil(half_extent).to(torch.int32), 0)

    # view-space normal, sign-flipped toward the camera
    n_view = t_n @ r_w2c.T
    p_view = means3d @ r_w2c.T + t_w2c
    cos = -(p_view * n_view).sum(dim=-1)
    n_view = n_view * torch.where(cos > 0, 1.0, -1.0).to(dt)[:, None]

    if colors_precomp is not None:
        color = colors_precomp
    else:
        dirs = means3d - cam.campos[None, :]
        dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
        color = torch.clamp_min(sh_lib.eval_sh(sh_degree, shs, dirs) + 0.5, 0.0)

    return SurfelPrep(M, zrow, xy, zc, n_view, color, opacity, radii, rect, valid)


def _adj_rows(M: torch.Tensor):
    c0, c1, c2 = M[:, :, 0], M[:, :, 1], M[:, :, 2]
    return (torch.linalg.cross(c1, c2, dim=-1), torch.linalg.cross(c2, c0, dim=-1),
            torch.linalg.cross(c0, c1, dim=-1))


def surfel_adj(M: torch.Tensor) -> torch.Tensor:
    """Normalized adjugate rows [N, 9] (a1 a2 a3, row-major).

    The ray-splat solve s = (r1 − px·r3) × (r2 − py·r3) expands to the linear
    form s = adj(M)·(px, py, 1), so the compositors evaluate three 2-term
    rows per (pixel, key). u = sx/sz and v = sy/sz do not change when the
    rows are scaled, so dividing by the largest |entry| (a detached
    constant, like the JAX package's stop_gradient) keeps every value and
    gradient downstream exact while keeping float32 well scaled."""
    a = torch.cat(_adj_rows(M), dim=1)
    nrm = torch.clamp_min(a.abs().max(dim=1, keepdim=True).values, 1e-30).detach()
    return a / nrm


def surfel_cull_ellipses(prep: SurfelPrep) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-surfel screen ellipses for K1's alpha >= 1/255 tile cull, two
    [N, 6] arrays (cx, cy, A, B, C, threshold).

    alpha = opa·exp(−min(rho3d, rho2d)/2) reaches 1/255 in a tile iff the
    minimum of rho3d or of rho2d over the tile is <= t2 = 2·log(255·opa):
      * {rho3d <= t2} is the image of the UV disc u² + v² <= t2 under the
        homography, the conic pᵀ [adj(M)ᵀ diag(1, 1, −t2) adj(M)] p <= 0,
        completed to the centered form (p − x0)ᵀ A' (p − x0) <= rho;
      * {rho2d <= t2} is the low-pass circle A = C = FILTER_INV_SQUARE
        around the projected center.
    A conic that is not positive definite, or whose centre lies more than
    1e6 px away, is force-kept by a huge finite threshold (1e30); an empty
    ellipse (rho < 0) keeps only through the circle.

    The conic is completed in float64 (the JAX package does it in float32)
    and rounded to float32 at the end: for a surfel seen nearly edge-on,
    A·C − B² cancels to ~1e-2 of A·C and float32 moves the centre and the
    threshold far enough to drop keys that reach alpha >= 1/255 (measured on
    bench.py's scene at 800x600: 2 of 1,712 culled keys)."""
    n = prep.xy.shape[0]
    t2 = _t2(prep.opacity).double()
    a1, a2, a3 = _adj_rows(prep.M.double())
    # scale-invariant test: normalize adj to keep the quartic in M in f32
    nrm = torch.clamp_min(
        torch.maximum(a1.abs(), torch.maximum(a2.abs(), a3.abs())).max(dim=1).values, 1e-30
    )[:, None]
    a1, a2, a3 = a1 / nrm, a2 / nrm, a3 / nrm

    def q(i, j):
        return a1[:, i] * a1[:, j] + a2[:, i] * a2[:, j] - t2 * a3[:, i] * a3[:, j]

    A, B, C = q(0, 0), q(0, 1), q(1, 1)
    q0, q1, cq = q(0, 2), q(1, 2), q(2, 2)
    det2 = A * C - B * B
    pd = (A > 0.0) & (C > 0.0) & (det2 > 0.0)
    inv_det = 1.0 / torch.where(pd, det2, 1.0)
    x0 = (B * q1 - C * q0) * inv_det
    y0 = (B * q0 - A * q1) * inv_det
    ok = pd & (x0.abs() < 1e6) & (y0.abs() < 1e6)
    rho = -(cq + q0 * x0 + q1 * y0)
    ell = torch.stack([
        torch.where(ok, x0, 0.0), torch.where(ok, y0, 0.0), torch.where(ok, A, 1.0),
        torch.where(ok, B, 0.0), torch.where(ok, C, 1.0), torch.where(ok, rho, 1e30),
    ], dim=1)
    f = torch.full((n,), FILTER_INV_SQUARE, dtype=ell.dtype, device=ell.device)
    circ = torch.stack([prep.xy[:, 0].double(), prep.xy[:, 1].double(), f, torch.zeros_like(f),
                        f, t2], dim=1)
    return ell.to(torch.float32), circ.to(torch.float32)


def surfel_table(prep: SurfelPrep) -> torch.Tensor:
    """[N, 21] per-surfel stream rows, in surfel order: adj(M) 0-8, zrow
    9-11, xy 12-13, color 14-16, normal 17-19, log2 opacity 20."""
    return torch.cat(
        [surfel_adj(prep.M), prep.zrow, prep.xy, prep.color, prep.normal,
         log2_opacity(prep.opacity)[:, None]],
        dim=1,
    )


def surfel_frame_plain(means3d: torch.Tensor, opacities: torch.Tensor, cam: Camera,
                       **kw) -> SurfelFrame:
    """The eval path's per-surfel work by the plain stages
    (`preprocess_surfel`, `surfel_table`, `surfel_cull_ellipses`), which
    `fused_surfel_preprocess.preprocess_surfel_kernel` computes in one CUDA
    launch; `kw` are `preprocess_surfel`'s keyword arguments."""
    prep = preprocess_surfel(means3d, opacities, cam, **kw)
    ell, circ = surfel_cull_ellipses(prep)
    return SurfelFrame(prep.xy, prep.depth, prep.rect, prep.valid, prep.radii,
                       surfel_table(prep), ell, circ)


def depth_to_normal(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Pseudo surface normal from a depth map ([1,H,W] -> [3,H,W], world
    space): unproject to world points and cross the central differences.
    The border pixels are 0."""
    w, h = cam.width, cam.height
    dev, dt = depth.device, depth.dtype
    fx = w / (2.0 * cam.tanfovx)
    fy = h / (2.0 * cam.tanfovy)
    with span("sync.camera_inverse"):  # the inverse's error check reads its info to the host
        c2w = torch.linalg.inv(cam.viewmatrix.T)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                            torch.arange(w, dtype=dt, device=dev), indexing="ij")
    rays = torch.stack([(xs - w / 2.0) / fx, (ys - h / 2.0) / fy, torch.ones_like(xs)], -1)
    rays_w = rays @ c2w[:3, :3].T
    points = depth[0][..., None] * rays_w + c2w[:3, 3]
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    nrm = torch.linalg.cross(dx, dy, dim=-1)
    # eps inside the rsqrt: x/|x| has a NaN gradient at x = 0 even under a
    # zero cotangent (0 * nan), which would poison zero-weighted loss terms
    nrm = nrm * torch.rsqrt((nrm * nrm).sum(dim=-1, keepdim=True) + 1e-20)
    return F.pad(nrm, (0, 0, 1, 1, 1, 1)).permute(2, 0, 1)


def surfel_maps(out: SurfelOutput, cam: Camera, depth_ratio: float):
    """(render_normal, render_depth, surf_normal) of a rasterize_surfel
    output: the view normal in world space, the expected/median depth mix,
    and the normal of that depth map times the detached alpha."""
    alpha = out.alpha
    # view -> world normal (row-vector: n_world = n_view @ R_w2c = n_view @ V[:3,:3].T)
    render_normal = (out.normal.permute(1, 2, 0) @ cam.viewmatrix[:3, :3].T).permute(2, 0, 1)
    depth_exp = expected_depth(out.depth_accum, alpha)
    depth_med = torch.nan_to_num(out.depth_median, nan=0.0, posinf=0.0, neginf=0.0)
    surf_depth = depth_exp * (1.0 - depth_ratio) + depth_ratio * depth_med
    surf_normal = depth_to_normal(cam, surf_depth) * alpha.detach()
    return render_normal, surf_depth, surf_normal
