"""The plain 3DGS rasterizer the benchmark judges the program by: plain
PyTorch, float32, no kernel, written from the 3DGS paper's equations and
the original CUDA rasterizer's conventions.

Per Gaussian: the EWA projection with the 0.3 px dilation, the screen
radius ceil(3 sigma), the tile rect (16 px tiles) of the pixels where its
alpha can reach 1/255, and the view-dependent colour from SH degree 3. Per
pixel: the Gaussians whose rect holds the pixel's tile, front to back by
view depth; alpha = min(0.99, o exp(-q/2)), skipped below 1/255; a Gaussian
is blended while the transmittance after it stays >= 1e-4, and the first
one that would cross that ends the pixel. Colour adds T bg, depth is the
alpha-weighted view z, alpha is 1 - T.

The blend runs densely over blocks of tiles with their lists padded to the
block's longest (`BLOCK_ELEMENTS` per block), with cumulative products for
the transmittance, so that autograd runs through it. Training takes two
passes: the images without a graph, then, per block, the block again with
its graph and the loss's gradient on its pixels (`backward_tiles`).

`dtype` computes the blend (everything after the pixel offsets) in a lower
precision: the control that the correctness limits have to reject.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
PIXELS = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK_ELEMENTS = 1 << 25
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh3(sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Real SH up to degree 3: sh [N, 16, 3] at unit directions d [N, 3]."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    r = SH_C0 * sh[:, 0]
    r = r - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    r = (r + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
         + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
         + SH_C2[4] * (xx - yy) * sh[:, 8])
    r = (r + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
         + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
         + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
         + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
         + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return r


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.sqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


class Projected(NamedTuple):
    table: torch.Tensor     # [N, 10]: x, y, conic A B C, r g b, view z, opacity
    rect: torch.Tensor      # [N, 4] int64 tile rect x0, y0, x1, y1 (half-open)
    valid: torch.Tensor     # [N] bool


def project(params: dict, alive: torch.Tensor, cam: dict) -> Projected:
    """Per-Gaussian projection of raw parameters (3 scale columns)."""
    xyz = params["xyz"]
    n = xyz.shape[0]
    w, h = cam["width"], cam["height"]
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    hom = torch.cat([xyz, xyz.new_ones(n, 1)], 1)
    pv = (hom[:, None, :] * cam["view"][None, :3, :]).sum(-1)       # [N, 3]
    clip = (hom[:, None, :] * cam["full"][None]).sum(-1)            # [N, 4]
    inv_w = 1.0 / (clip[:, 3] + 1e-7)
    px = ((clip[:, 0] * inv_w + 1.0) * w - 1.0) * 0.5
    py = ((clip[:, 1] * inv_w + 1.0) * h - 1.0) * 0.5
    z = pv[:, 2]
    in_front = z > 0.2
    zs = torch.where(in_front, z, torch.ones_like(z))

    R = quat_rotmat(params["rotation"])
    s2 = torch.exp(params["scaling"]) ** 2
    sigma = ((R[:, :, None, :] * R[:, None, :, :]) * s2[:, None, None, :]).sum(-1)  # R S^2 R^t
    fx = w / (2.0 * cam["tanx"])
    fy = h / (2.0 * cam["tany"])
    tx = torch.clamp(pv[:, 0] / zs, -1.3 * cam["tanx"], 1.3 * cam["tanx"]) * zs
    ty = torch.clamp(pv[:, 1] / zs, -1.3 * cam["tany"], 1.3 * cam["tany"]) * zs
    zeros = torch.zeros_like(zs)
    J = torch.stack([fx / zs, zeros, -fx * tx / (zs * zs),
                     zeros, fy / zs, -fy * ty / (zs * zs)], -1).reshape(n, 2, 3)
    T = (J[:, :, :, None] * cam["view"][None, None, :3, :3]).sum(2)  # J @ W, [N, 2, 3]
    cov = ((T[:, :, None, :, None] * sigma[:, None, None, :, :]
            * T[:, None, :, None, :]).sum((-1, -2)))                  # T Sigma T^t
    a = cov[:, 0, 0] + 0.3
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))

    opacity = torch.sigmoid(params["opacity"][:, 0])
    t2 = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opacity, 1e-12) * 255.0), 0.0)
    with torch.no_grad():
        rx = torch.minimum(radius, torch.sqrt(t2 * torch.clamp_min(a, 0.0)))
        ry = torch.minimum(radius, torch.sqrt(t2 * torch.clamp_min(c, 0.0)))
        keep = in_front & det_ok & (t2 > 0)
        rx = torch.where(keep, rx, 0.0)
        ry = torch.where(keep, ry, 0.0)

        def tile(v, hi):
            return torch.clamp(v, -1.0, hi + 1.0).to(torch.int64).clamp(0, hi)

        x0 = tile((px - rx) / TILE, tiles_x)
        y0 = tile((py - ry) / TILE, tiles_y)
        x1 = tile((px + rx + TILE - 1) / TILE, tiles_x)
        y1 = tile((py + ry + TILE - 1) / TILE, tiles_y)
        valid = keep & (x1 > x0) & (y1 > y0) & ((rx > 0) | (ry > 0)) & alive
        rect = torch.stack([x0, y0, x1, y1], -1)

    dirs = xyz - cam["center"]
    dirs = dirs * torch.rsqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-20)
    sh = torch.cat([params["f_dc"], params["f_rest"]], 1)
    color = torch.clamp_min(eval_sh3(sh, dirs) + 0.5, 0.0)
    table = torch.cat([px[:, None], py[:, None], conic, color, z[:, None], opacity[:, None]], 1)
    return Projected(table, rect, valid)


class Bins(NamedTuple):
    gid: torch.Tensor        # [K] Gaussian of each (tile, Gaussian) pair, by tile then depth
    start: torch.Tensor      # [n_tiles] first pair of each tile
    count: torch.Tensor      # [n_tiles]
    tiles_x: int
    tiles_y: int


def bin_tiles(depth: torch.Tensor, rect: torch.Tensor, valid: torch.Tensor, width: int,
              height: int) -> Bins:
    """Every (tile, Gaussian) pair of the valid Gaussians' rects, grouped by
    tile and ordered by view depth (ties by row) inside each tile."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    dev = depth.device
    idx = valid.nonzero()[:, 0]
    idx = idx[torch.sort(depth[idx], stable=True).indices]
    r = rect[idx]
    wx = r[:, 2] - r[:, 0]
    cnt = wx * (r[:, 3] - r[:, 1])
    first = torch.cumsum(cnt, 0) - cnt
    k = int(cnt.sum())
    rank = torch.repeat_interleave(torch.arange(len(idx), device=dev), cnt, output_size=k)
    j = torch.arange(k, device=dev) - first[rank]
    tile = (r[rank, 1] + j // wx[rank]) * tiles_x + r[rank, 0] + j % wx[rank]
    order = torch.sort(tile * max(len(idx), 1) + rank).indices
    n_tiles = tiles_x * tiles_y
    count = torch.bincount(tile[order], minlength=n_tiles)
    start = torch.cumsum(count, 0) - count
    return Bins(idx[rank[order]], start, count, tiles_x, tiles_y)


def blocks(bins: Bins):
    """Blocks of tiles with like list lengths: (tile ids, list length)."""
    order = torch.sort(bins.count, descending=True, stable=True).indices
    counts = bins.count[order].tolist()
    i, n = 0, len(counts)
    while i < n and counts[i] > 0:
        length = counts[i]
        b = max(1, BLOCK_ELEMENTS // (PIXELS * length))
        yield order[i:i + b], length
        i += b


def blend_block(table: torch.Tensor, bins: Bins, tiles: torch.Tensor, length: int,
                bg: torch.Tensor, dtype=torch.float32):
    """Blend the tiles of one block -> (color [B, 3, P], depth [B, P],
    alpha [B, P], walked pairs, live keys). `table` has one zero row more
    than the Gaussians, which pads the lists."""
    dev = table.device
    null = table.shape[0] - 1
    slot = torch.arange(length, device=dev)
    cnt = bins.count[tiles]
    idx = torch.where(slot[None] < cnt[:, None], bins.start[tiles][:, None] + slot[None], -1)
    gid = torch.where(idx >= 0, bins.gid[idx.clamp_min(0)], null)
    rows = table[gid]                                              # [B, L, 10]
    pix = torch.arange(PIXELS, device=dev)
    px = ((tiles % bins.tiles_x)[:, None] * TILE + pix % TILE).to(torch.float32)
    py = ((tiles // bins.tiles_x)[:, None] * TILE + pix // TILE).to(torch.float32)
    dx = (rows[:, None, :, 0] - px[:, :, None]).to(dtype)          # [B, P, L]
    dy = (rows[:, None, :, 1] - py[:, :, None]).to(dtype)
    r = rows.to(dtype)
    q = r[:, None, :, 2] * dx * dx + 2.0 * r[:, None, :, 3] * dx * dy + r[:, None, :, 4] * dy * dy
    alpha = torch.clamp_max(r[:, None, :, 9] * torch.exp(-0.5 * q), ALPHA_MAX)
    alpha = torch.where(alpha >= ALPHA_MIN, alpha, 0.0)
    with torch.no_grad():
        t_all = torch.cumprod(1.0 - alpha, -1)
        inc = (alpha > 0) & (t_all >= T_EPS)
        t_prev = torch.cat([torch.ones_like(t_all[..., :1]), t_all[..., :-1]], -1)
        walked = int(((alpha > 0) & (t_prev >= T_EPS)).sum())
        live = int((alpha > 0).any(1).sum())
    a = torch.where(inc, alpha, 0.0)
    t_incl = torch.cumprod(1.0 - a, -1)
    weight = a * torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], -1)
    t_final = t_incl[..., -1]
    color = torch.einsum("bpl,blc->bcp", weight, r[..., 5:8]) + \
        t_final[:, None, :] * bg.to(dtype)[None, :, None]
    depth = (weight * r[:, None, :, 8]).sum(-1)
    return color.float(), depth.float(), (1.0 - t_final).float(), walked, live


class Frame(NamedTuple):
    color: torch.Tensor   # [3, H, W]
    depth: torch.Tensor   # [1, H, W] alpha-weighted view z
    alpha: torch.Tensor   # [1, H, W]
    pairs: int            # (pixel, Gaussian) pairs blended up to each pixel's last
    keys: int             # (tile, Gaussian) pairs with a pixel at alpha >= 1/255


def to_image(t: torch.Tensor, bins: Bins, width: int, height: int) -> torch.Tensor:
    """[n_tiles, C, 256] tile-major -> [C, H, W]."""
    c = t.shape[1]
    img = t.reshape(bins.tiles_y, bins.tiles_x, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return img.reshape(c, bins.tiles_y * TILE, bins.tiles_x * TILE)[:, :height, :width]


def to_tiles(img: torch.Tensor, bins: Bins) -> torch.Tensor:
    """[C, H, W] -> [n_tiles, C, 256], zero beyond the image."""
    c, h, w = img.shape
    full = img.new_zeros(c, bins.tiles_y * TILE, bins.tiles_x * TILE)
    full[:, :h, :w] = img
    t = full.reshape(c, bins.tiles_y, TILE, bins.tiles_x, TILE).permute(1, 3, 0, 2, 4)
    return t.reshape(bins.tiles_y * bins.tiles_x, c, PIXELS)


def padded(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, table.new_zeros(1, table.shape[1])])


def forward(table: torch.Tensor, bins: Bins, bg: torch.Tensor, width: int, height: int,
            dtype=torch.float32) -> Frame:
    """The images of one view, without a graph."""
    n_tiles = bins.tiles_x * bins.tiles_y
    dev = table.device
    color = bg.float()[None, :, None].expand(n_tiles, 3, PIXELS).clone()
    depth = torch.zeros(n_tiles, PIXELS, device=dev)
    alpha = torch.zeros(n_tiles, PIXELS, device=dev)
    pairs = keys = 0
    tab = padded(table.detach())
    with torch.no_grad():
        for tiles, length in blocks(bins):
            c, d, a, walked, live = blend_block(tab, bins, tiles, length, bg, dtype)
            color[tiles], depth[tiles], alpha[tiles] = c, d, a
            pairs += walked
            keys += live
    return Frame(to_image(color, bins, width, height), to_image(depth[:, None], bins, width, height),
                 to_image(alpha[:, None], bins, width, height), pairs, keys)


def backward_tiles(table: torch.Tensor, bins: Bins, bg: torch.Tensor, g_color: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """d loss / d table [N, 10] from the loss's gradient on the colour image
    [3, H, W], block by block (each block's blend again, with its graph)."""
    g_tiles = to_tiles(g_color, bins)
    leaf = padded(table.detach()).requires_grad_(True)
    for tiles, length in blocks(bins):
        c, _, _, _, _ = blend_block(leaf, bins, tiles, length, bg, dtype)
        torch.autograd.backward(c, g_tiles[tiles])
    return leaf.grad[:-1]


def tf32_off():
    """A context that keeps matrix products and convolutions in full float32."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
    return _Ctx()


def render(params: dict, alive: torch.Tensor, cam: dict, bg: torch.Tensor,
           dtype=torch.float32) -> Frame:
    with torch.no_grad(), tf32_off():
        p = project(params, alive, cam)
        bins = bin_tiles(p.table[:, 8], p.rect, p.valid, cam["width"], cam["height"])
        return forward(p.table, bins, bg, cam["width"], cam["height"], dtype)
