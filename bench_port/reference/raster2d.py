"""The plain 2DGS (surfel) rasterizer the benchmark judges the program by:
plain PyTorch, float32, no kernel, from the 2DGS paper's ray-splat
intersection and its CUDA rasterizer's conventions.

Per surfel: the homography M from its (u, v, 1) plane to homogeneous
pixels (intrinsics with the principal point at (w/2 - 0.5, h/2 - 0.5)),
its view depth as a linear function of (u, v, 1), the camera-facing view
normal, the SH colour and the tile rect (the splat's +-c corners,
c = min(sqrt(2 ln(255 o)), 3), unioned with the low-pass disc). Per pixel,
front to back by the centre's view depth: (u, v) from the adjugate rows
(u, v clipped to +-1e3), rho = min(u^2 + v^2, 2 |centre - pixel|^2),
alpha = min(0.99, o exp(-rho/2)), z the plane's depth at (u, v) or the
centre's where the low-pass wins; skipped below alpha 1/255 or z 0.2;
blended while the transmittance after it stays >= 1e-4. Outputs: colour
+ T bg, alpha, the weighted view normal, and the median depth (the z of
the last blended surfel entered at transmittance > 0.5). The distortion
map is not formed: the configuration weighs it 0.

As raster3d.py, the blend runs densely over blocks of tiles; `dtype`
computes it in a lower precision for the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .raster3d import (ALPHA_MAX, ALPHA_MIN, PIXELS, T_EPS, TILE, bin_tiles, blocks, eval_sh3,
                       padded, quat_rotmat, tf32_off, to_image, to_tiles)

NEAR = 0.2
FILTER_INV_SQUARE = 2.0
COLS = 21  # adj rows 9, depth row 3, centre 2, colour 3, normal 3, opacity 1


class Projected(NamedTuple):
    table: torch.Tensor   # [N, 21]
    depth: torch.Tensor   # [N] centre view z
    rect: torch.Tensor    # [N, 4] int64
    valid: torch.Tensor   # [N] bool


def project(params: dict, alive: torch.Tensor, cam: dict) -> Projected:
    """Per-surfel projection of raw parameters (2 scale columns)."""
    xyz = params["xyz"]
    w, h = cam["width"], cam["height"]
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    Rw = cam["view"][:3, :3]
    tw = cam["view"][:3, 3]
    fx = w / (2.0 * cam["tanx"])
    fy = h / (2.0 * cam["tany"])
    z0 = torch.zeros_like(fx)
    K = torch.stack([torch.stack([fx, z0, z0 + (w * 0.5 - 0.5)]),
                     torch.stack([z0, fy, z0 + (h * 0.5 - 0.5)]),
                     torch.stack([z0, z0, z0 + 1.0])])
    A = (K[:, :, None] * Rw[None, :, :]).sum(1)          # K @ Rw
    b = (K * tw[None, :]).sum(1)                         # K @ tw
    R = quat_rotmat(params["rotation"])
    s = torch.exp(params["scaling"])
    axis_u = R[:, :, 0] * s[:, 0:1]
    axis_v = R[:, :, 1] * s[:, 1:2]

    def apply(mat, vec):
        return (vec[:, None, :] * mat[None]).sum(-1)

    M0, M1, M2 = apply(A, axis_u), apply(A, axis_v), apply(A, xyz) + b
    zrow = torch.stack([(axis_u * Rw[2]).sum(-1), (axis_v * Rw[2]).sum(-1),
                        (xyz * Rw[2]).sum(-1) + tw[2]], -1)
    zc = zrow[:, 2]
    in_front = zc > NEAR
    wc = torch.where(M2[:, 2].abs() > 1e-8, M2[:, 2], 1e-8)
    px, py = M2[:, 0] / wc, M2[:, 1] / wc
    opacity = torch.sigmoid(params["opacity"][:, 0])
    with torch.no_grad():
        t2 = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-12) * 255.0), 0.0)
        c = torch.clamp_max(torch.sqrt(t2), 3.0)[:, None]
        cx, cy = [], []
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                hom = M2 + c * (sx * M0 + sy * M1)
                wk = torch.clamp_min(hom[:, 2], 1e-2)
                cx.append(hom[:, 0] / wk)
                cy.append(hom[:, 1] / wk)
        r_lp = torch.sqrt(t2 / FILTER_INV_SQUARE)
        lo_x = torch.minimum(torch.stack(cx).min(0).values, px - r_lp)
        lo_y = torch.minimum(torch.stack(cy).min(0).values, py - r_lp)
        hi_x = torch.maximum(torch.stack(cx).max(0).values, px + r_lp)
        hi_y = torch.maximum(torch.stack(cy).max(0).values, py + r_lp)

        def tile(v, hi):
            return torch.clamp(v, -1.0, hi + 1.0).to(torch.int64).clamp(0, hi)

        x0, y0 = tile(lo_x / TILE, tiles_x), tile(lo_y / TILE, tiles_y)
        x1 = tile((hi_x + TILE - 1) / TILE, tiles_x)
        y1 = tile((hi_y + TILE - 1) / TILE, tiles_y)
        valid = in_front & (t2 > 0) & (x1 > x0) & (y1 > y0) & alive
        rect = torch.stack([x0, y0, x1, y1], -1)

    cols = torch.stack([M0, M1, M2], -1)                 # [N, 3, 3], columns
    a1 = torch.linalg.cross(cols[:, :, 1], cols[:, :, 2], dim=-1)
    a2 = torch.linalg.cross(cols[:, :, 2], cols[:, :, 0], dim=-1)
    a3 = torch.linalg.cross(cols[:, :, 0], cols[:, :, 1], dim=-1)
    adj = torch.cat([a1, a2, a3], 1)
    adj = adj / torch.clamp_min(adj.abs().max(1, keepdim=True).values, 1e-30).detach()
    n_view = (R[:, None, :, 2] * Rw[None]).sum(-1)        # Rw @ t_n
    p_view = (xyz[:, None, :] * Rw[None]).sum(-1) + tw
    facing = -(p_view * n_view).sum(-1) > 0
    n_view = n_view * torch.where(facing, 1.0, -1.0)[:, None]
    dirs = xyz - cam["center"]
    dirs = dirs * torch.rsqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-20)
    sh = torch.cat([params["f_dc"], params["f_rest"]], 1)
    color = torch.clamp_min(eval_sh3(sh, dirs) + 0.5, 0.0)
    table = torch.cat([adj, zrow, px[:, None], py[:, None], color, n_view, opacity[:, None]], 1)
    return Projected(table, zc, rect, valid)


def blend_block(table, bins, tiles, length, bg, dtype=torch.float32):
    """One block -> (color [B,3,P], alpha [B,P], normal [B,3,P], median
    [B,P], walked pairs, live keys)."""
    dev = table.device
    null = table.shape[0] - 1
    slot = torch.arange(length, device=dev)
    cnt = bins.count[tiles]
    idx = torch.where(slot[None] < cnt[:, None], bins.start[tiles][:, None] + slot[None], -1)
    gid = torch.where(idx >= 0, bins.gid[idx.clamp_min(0)], null)
    rows = table[gid]                                    # [B, L, 21]
    pix = torch.arange(PIXELS, device=dev)
    x = ((tiles % bins.tiles_x)[:, None] * TILE + pix % TILE).float()[:, :, None]  # [B, P, 1]
    y = ((tiles // bins.tiles_x)[:, None] * TILE + pix // TILE).float()[:, :, None]

    def col(i):
        return rows[:, None, :, i]                       # [B, 1, L]

    sx = col(0) * x + col(1) * y + col(2)
    sy = col(3) * x + col(4) * y + col(5)
    sz = col(6) * x + col(7) * y + col(8)
    sz = torch.where(sz.abs() > 1e-9, sz, 1e-9)
    u = torch.clamp(sx / sz, -1e3, 1e3)
    v = torch.clamp(sy / sz, -1e3, 1e3)
    dx, dy = col(12) - x, col(13) - y
    r = rows.to(dtype)
    rho3 = (u * u + v * v).to(dtype)
    rho2 = (FILTER_INV_SQUARE * (dx * dx + dy * dy)).to(dtype)
    use3 = rho3 <= rho2
    rho = torch.minimum(rho3, rho2)
    alpha = torch.clamp_max(r[:, None, :, 20] * torch.exp(-0.5 * rho), ALPHA_MAX)
    z = torch.where(use3, u.to(dtype) * r[:, None, :, 9] + v.to(dtype) * r[:, None, :, 10]
                    + r[:, None, :, 11], r[:, None, :, 11])
    alpha = torch.where((alpha >= ALPHA_MIN) & (z >= NEAR), alpha, 0.0)
    with torch.no_grad():
        t_all = torch.cumprod(1.0 - alpha, -1)
        inc = (alpha > 0) & (t_all >= T_EPS)
        t_prev = torch.cat([torch.ones_like(t_all[..., :1]), t_all[..., :-1]], -1)
        walked = int(((alpha > 0) & (t_prev >= T_EPS)).sum())
        live = int((alpha > 0).any(1).sum())
    a = torch.where(inc, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - a, -1)
    t_before = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    weight = a * t_before
    t_final = t_incl[..., -1]
    color = torch.einsum("bpl,blc->bcp", weight, r[..., 14:17]) + \
        t_final[:, None, :] * bg.to(dtype)[None, :, None]
    normal = torch.einsum("bpl,blc->bcp", weight, r[..., 17:20])
    with torch.no_grad():
        is_med = inc & (t_before > 0.5)
        last = torch.where(is_med, slot[None, None, :], -1).max(-1).values  # [B, P]
    median = torch.where(last >= 0, z.gather(-1, last.clamp_min(0)[..., None])[..., 0], 0.0)
    return (color.float(), (1.0 - t_final).float(), normal.float(), median.float(), walked, live)


class Frame(NamedTuple):
    color: torch.Tensor    # [3, H, W]
    alpha: torch.Tensor    # [1, H, W]
    normal: torch.Tensor   # [3, H, W] view space, weighted
    median: torch.Tensor   # [1, H, W]
    pairs: int
    keys: int

    @property
    def depth(self):
        return self.median * self.alpha  # alpha-weighted, as raster3d's Frame.depth


def forward(table, bins, bg, width, height, dtype=torch.float32) -> Frame:
    n_tiles = bins.tiles_x * bins.tiles_y
    dev = table.device
    color = bg.float()[None, :, None].expand(n_tiles, 3, PIXELS).clone()
    alpha = torch.zeros(n_tiles, PIXELS, device=dev)
    normal = torch.zeros(n_tiles, 3, PIXELS, device=dev)
    median = torch.zeros(n_tiles, PIXELS, device=dev)
    pairs = keys = 0
    tab = padded(table.detach())
    with torch.no_grad():
        for tiles, length in blocks(bins):
            c, a, nrm, med, walked, live = blend_block(tab, bins, tiles, length, bg, dtype)
            color[tiles], alpha[tiles], normal[tiles], median[tiles] = c, a, nrm, med
            pairs += walked
            keys += live
    return Frame(to_image(color, bins, width, height), to_image(alpha[:, None], bins, width, height),
                 to_image(normal, bins, width, height), to_image(median[:, None], bins, width, height),
                 pairs, keys)


def backward_tiles(table, bins, bg, g_color, g_normal, g_median, dtype=torch.float32):
    """d loss / d table from the loss's gradients on the colour, normal and
    median maps, block by block."""
    gc, gn, gm = to_tiles(g_color, bins), to_tiles(g_normal, bins), to_tiles(g_median, bins)
    leaf = padded(table.detach()).requires_grad_(True)
    for tiles, length in blocks(bins):
        c, _, nrm, med, _, _ = blend_block(leaf, bins, tiles, length, bg, dtype)
        torch.autograd.backward([c, nrm, med], [gc[tiles], gn[tiles], gm[tiles][:, 0]])
    return leaf.grad[:-1]


def facing_cos(params: dict, cam: dict) -> torch.Tensor:
    """[N] |cos| of the angle between each surfel's normal (its rotation's
    third axis) and the ray from the camera's centre to the surfel's
    centre: near 0 the surfel is seen edge-on, its (u, v) divides by a
    vanishing length and two float32 orders of the same sums part."""
    with torch.no_grad():
        n = quat_rotmat(params["rotation"])[:, :, 2]
        ray = params["xyz"] - cam["center"]
        ray = ray / torch.clamp_min(ray.norm(dim=-1, keepdim=True), 1e-12)
        return (ray * n).sum(-1).abs()


def depth_to_normal(cam: dict, depth: torch.Tensor) -> torch.Tensor:
    """World-space normal of a depth map [1, H, W] -> [3, H, W] from the
    cross product of central differences of its unprojected points (rays
    through the pixel corners' grid, x - w/2); 0 on the border."""
    w, h = cam["width"], cam["height"]
    fx = w / (2.0 * cam["tanx"])
    fy = h / (2.0 * cam["tany"])
    c2w = torch.linalg.inv(cam["view"])
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device, dtype=torch.float32),
                            torch.arange(w, device=depth.device, dtype=torch.float32),
                            indexing="ij")
    rays = torch.stack([(xs - w / 2.0) / fx, (ys - h / 2.0) / fy, torch.ones_like(xs)], -1)
    rays_w = (rays[..., None, :] * c2w[:3, :3]).sum(-1)
    pts = depth[0][..., None] * rays_w + c2w[:3, 3]
    ddx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    ddy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(ddx, ddy, dim=-1)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-20)
    return F.pad(n, (0, 0, 1, 1, 1, 1)).permute(2, 0, 1)


def render(params, alive, cam, bg, dtype=torch.float32) -> Frame:
    with torch.no_grad(), tf32_off():
        p = project(params, alive, cam)
        bins = bin_tiles(p.depth, p.rect, p.valid, cam["width"], cam["height"])
        return forward(p.table, bins, bg, cam["width"], cam["height"], dtype)
