"""Kernel K3: the backward compositor, K2's reverse walk per 16x16 tile.

Counterpart of `scorp_tpu/ops/raster/pallas_bwd.py` (`_bwd_kernel`,
entered through `backward_kernel_call`) and of the scatter that reduced its
per-key blocks onto gaussians (`pallas.py:72 compact_block_scatter`). The
CUDA source is `csrc/backward.cu`; `composite_backward_plain` below is the
same walk in PyTorch over key chunks of all tiles at once, reduced onto
gaussians with `index_add_`.

Gradient contract (the CUDA reference's): per pixel, keys at stream
positions j < n_contrib with alpha >= 1/255 are walked back to front;
T_before = T / (1 - alpha) is rebuilt from K2's t_final, S is the suffix sum
of w·u with u = c·g_C + z·g_D, and
  dalpha = T_before·u - (S + T_final·(bg·g_C - g_A)) / (1 - alpha),
  dpow = alpha_u·dalpha with alpha_u = 2^(power + lopa)
(the gradient passes the 0.99 clamp). The 10 rows per key: d_gx = -l11 r_u,
d_gy = -(l21 r_u + l22 r_v), d_l11/d_l21/d_l22 = -ln2 Σ (su dx, su dy,
sv dy)·dpow, d_rgb = Σ w·g_C, d_z = Σ w·g_D, d_lopa = ln2 Σ dpow, where
r_u = ln2 Σ su·dpow and r_v = ln2 Σ sv·dpow.
"""

from __future__ import annotations

import math

import torch

from .._build import check_tensor, load
from .common import ALPHA_MAX, ALPHA_MIN, DATA_ROWS
from .composite import PIXELS, PLAIN_CHUNK, pixel_coords

REPLACES = "scorp_tpu/ops/raster/pallas_bwd.py:87 _bwd_kernel"
SOURCE = "scorp_tpu_torch/csrc/backward.cu"
LN2 = math.log(2.0)


def composite_backward_plain(data, gid, tile_start, tile_count, bg, g_color, g_depth,
                             g_alpha, t_final, n_contrib, n_rows: int, *, tiles_x: int):
    """Plain PyTorch version of the kernel, same arguments and output. Alphas
    are evaluated for a chunk of keys of every tile at once, walked back to
    front; T and S then step key by key in the kernel's order, and the
    per-key rows are reduced over pixels and added onto gaussians with
    `index_add_`. It computes in `data`'s dtype."""
    dev, dt = data.device, data.dtype
    n_tiles = tile_start.shape[0]
    px, py = pixel_coords(n_tiles, tiles_x, dt, dev)                      # [T, P]
    nc = n_contrib[:, 0].to(torch.int64)                                  # [T, P]
    gc, gd = g_color, g_depth[:, 0]
    gt_term = t_final[:, 0] * (bg[0] * gc[:, 0] + bg[1] * gc[:, 1] + bg[2] * gc[:, 2]
                               - g_alpha[:, 0])
    trans = t_final[:, 0].clone()
    suffix = torch.zeros_like(trans)
    zero = torch.zeros((), dtype=dt, device=dev)
    d_table = torch.zeros(n_rows, DATA_ROWS, dtype=dt, device=dev)
    # per tile, the last key any pixel included
    m = torch.minimum(nc.max(dim=1).values, tile_count.to(torch.int64)) if n_tiles else nc
    max_m = int(m.max()) if n_tiles else 0

    for c0 in reversed(range(0, max_m, PLAIN_CHUNK)):
        j = torch.arange(c0, min(c0 + PLAIN_CHUNK, max_m), device=dev)
        valid = j[None, :] < m[:, None]                                    # [T, C]
        idx = tile_start[:, None].to(torch.int64) + j[None, :]
        rows = data[idx.clamp_max(data.shape[0] - 1)]                      # [T, C, 10]
        dx = rows[..., 0:1] - px[:, None, :]                               # [T, C, P]
        dy = rows[..., 1:2] - py[:, None, :]
        su = rows[..., 2:3] * dx + rows[..., 3:4] * dy
        sv = rows[..., 4:5] * dy
        power = -0.5 * (su * su + sv * sv)
        alpha_u = torch.exp2(power + rows[..., 9:10])
        alpha = torch.clamp_max(alpha_u, ALPHA_MAX)
        emit = (valid[..., None] & (j[None, :, None] < nc[:, None, :])
                & (alpha >= ALPHA_MIN))
        cu = (rows[..., 5:6] * gc[:, None, 0] + rows[..., 6:7] * gc[:, None, 1]
              + rows[..., 7:8] * gc[:, None, 2] + rows[..., 8:9] * gd[:, None])
        w = torch.zeros_like(alpha)
        dpow = torch.zeros_like(alpha)
        for i in reversed(range(j.shape[0])):
            e, a = emit[:, i], alpha[:, i]
            one_minus = 1.0 - a
            t_before = torch.where(e, trans / one_minus, trans)
            wi = torch.where(e, a * t_before, zero)
            dalpha = torch.where(e, t_before * cu[:, i] - (suffix + gt_term) / one_minus, zero)
            w[:, i] = wi
            dpow[:, i] = alpha_u[:, i] * dalpha
            suffix = suffix + wi * cu[:, i]
            trans = t_before
        ud = su * dpow
        vd = sv * dpow
        r_u = LN2 * ud.sum(-1)                                             # [T, C]
        r_v = LN2 * vd.sum(-1)
        grads = torch.stack([
            -(rows[..., 2] * r_u),
            -(rows[..., 3] * r_u + rows[..., 4] * r_v),
            -LN2 * (ud * dx).sum(-1),
            -LN2 * (ud * dy).sum(-1),
            -LN2 * (vd * dy).sum(-1),
            (w * gc[:, None, 0]).sum(-1),
            (w * gc[:, None, 1]).sum(-1),
            (w * gc[:, None, 2]).sum(-1),
            (w * gd[:, None]).sum(-1),
            LN2 * dpow.sum(-1),
        ], dim=-1)                                                         # [T, C, 10]
        d_table.index_add_(0, gid[idx[valid]].to(torch.int64), grads[valid])
    return d_table


def composite_backward(data, gid, tile_start, tile_count, bg, g_color, g_depth, g_alpha,
                       t_final, n_contrib, n_rows: int, *, tiles_x: int):
    """K3 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `composite_backward_plain` for CPU tensors.

    data [K, 10] f32, the stream K2 read; gid [K] int32 gaussian row of each
    slot; tile_start/tile_count [T] int32; bg [3] f32; g_color [T,3,256],
    g_depth/g_alpha/t_final [T,1,256] f32; n_contrib [T,1,256] int32.
    Returns d_table [n_rows, 10] f32, the gradient of the per-gaussian table.
    """
    dev = data.device
    if dev.type == "cpu":
        return composite_backward_plain(data, gid, tile_start, tile_count, bg, g_color,
                                        g_depth, g_alpha, t_final, n_contrib, n_rows,
                                        tiles_x=tiles_x)
    if dev.type != "cuda":
        raise ValueError(f"composite_backward supports cpu and cuda tensors, not {dev}")
    n_tiles = tile_start.shape[0]
    check_tensor(data, "data", torch.float32, (data.shape[0], DATA_ROWS), dev)
    check_tensor(gid, "gid", torch.int32, (data.shape[0],), dev)
    check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,), dev)
    check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,), dev)
    check_tensor(bg, "bg", torch.float32, (3,), dev)
    check_tensor(g_color, "g_color", torch.float32, (n_tiles, 3, PIXELS), dev)
    for name, x in (("g_depth", g_depth), ("g_alpha", g_alpha), ("t_final", t_final)):
        check_tensor(x, name, torch.float32, (n_tiles, 1, PIXELS), dev)
    check_tensor(n_contrib, "n_contrib", torch.int32, (n_tiles, 1, PIXELS), dev)
    if n_tiles == 0 or tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"bad tile grid: {n_tiles} tiles, {tiles_x} per row")
    if n_rows <= 0:
        raise ValueError(f"bad row count {n_rows}")

    lib = load("backward")
    d_table = torch.zeros(n_rows, DATA_ROWS, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_composite_backward(
            data.data_ptr(), gid.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            bg.data_ptr(), g_color.data_ptr(), g_depth.data_ptr(), g_alpha.data_ptr(),
            t_final.data_ptr(), n_contrib.data_ptr(), d_table.data_ptr(),
            n_tiles, tiles_x, stream,
        )
    if err != 0:
        raise RuntimeError(f"backward kernel launch failed: cudaError {err}")
    composite_backward.launches += 1
    return d_table


composite_backward.launches = 0
