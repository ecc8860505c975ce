"""Kernel K6: the surfel backward compositor, K5's reverse walk per 16x16
tile.

Counterpart of `scorp_tpu/ops/raster/pallas_surfel_train.py`
(`_surfel_bwd_kernel`, entered through `_surfel_bwd_call`) and of the
side-carry blocks and scatter that reduced its per-key blocks onto surfels
(`compact_block_scatter`). The CUDA source is `csrc/surfel_backward.cu`;
`surfel_backward_plain` below is the same walk in PyTorch over key chunks of
all tiles at once, reduced onto surfels with `index_add_`. It is an explicit
reverse walk, not autograd through `surfel_composite_plain`: autograd would
stop the gradient at the 0.99 clamp, where this contract passes it.

Gradient contract (the CUDA source states it in full): per pixel, keys at
stream positions j < n_contrib with alpha >= 1/255 and z >= 0.2 are walked
back to front; T_before = T / (1 - alpha) is rebuilt from K5's T_final;
the distortion's VJP is closed-form in the totals A = 1 - T_final,
D = Σw·m and D2 = Σw·m² that K5 saved; the median depth's gradient goes to
the key at position n_med only; the u/v clip and the s_z clamp gate the
gradient as the JAX package's autodiff does. The 21 columns follow the
stream layout: d_adj 0-8, d_zrow 9-11, d_xy 12-13, d_color 14-16,
d_normal 17-19, d_lopa 20.
"""

from __future__ import annotations

import math

import torch

from .._build import check_tensor, load
from .composite import PIXELS, PLAIN_CHUNK, pixel_coords
from .surfel import ALPHA_MIN, FFN, FILTER_INV_SQUARE, NEAR_PLANE, SURFEL_COLS
from .surfel_composite import distortion_m, surfel_hit

REPLACES = "scorp_tpu/ops/raster/pallas_surfel_train.py:443 _surfel_bwd_kernel"
SOURCE = "scorp_tpu_torch/csrc/surfel_backward.cu"
LN2 = math.log(2.0)


def surfel_backward_plain(data, gid, tile_start, tile_count, bg, g_color, g_alpha, g_depth,
                          g_normal, g_median, g_dist, t_final, n_contrib, n_med, wm, wm2,
                          n_rows: int, *, tiles_x: int):
    """Plain PyTorch version of the kernel, same arguments and output. The
    per-(pixel, key) geometry is evaluated for a chunk of keys of every tile
    at once, walked back to front; T and S then step key by key in the
    kernel's order, and the per-key rows are reduced over pixels and added
    onto surfels with `index_add_`. It computes in `data`'s dtype."""
    dev, dt = data.device, data.dtype
    n_tiles = tile_start.shape[0]
    px, py = pixel_coords(n_tiles, tiles_x, dt, dev)                      # [T, P]
    nc = n_contrib[:, 0].to(torch.int64)                                  # [T, P]
    nm = n_med[:, 0].to(torch.int64)
    gc, gn = g_color, g_normal                                            # [T, 3, P]
    gd, gmed, gdist = g_depth[:, 0], g_median[:, 0], g_dist[:, 0]
    tf = t_final[:, 0]
    a_all, d_all, d2_all = 1.0 - tf, wm[:, 0], wm2[:, 0]
    gt_term = tf * (bg[0] * gc[:, 0] + bg[1] * gc[:, 1] + bg[2] * gc[:, 2] - g_alpha[:, 0])
    trans = tf.clone()
    suffix = torch.zeros_like(trans)
    zero = torch.zeros((), dtype=dt, device=dev)
    d_table = torch.zeros(n_rows, SURFEL_COLS, dtype=dt, device=dev)
    m_tile = torch.minimum(nc.max(dim=1).values, tile_count.to(torch.int64)) if n_tiles else nc
    max_m = int(m_tile.max()) if n_tiles else 0

    for c0 in reversed(range(0, max_m, PLAIN_CHUNK)):
        j = torch.arange(c0, min(c0 + PLAIN_CHUNK, max_m), device=dev)
        valid = j[None, :] < m_tile[:, None]                               # [T, C]
        idx = tile_start[:, None].to(torch.int64) + j[None, :]
        rows = data[idx.clamp_max(data.shape[0] - 1)]                      # [T, C, 21]
        hit = surfel_hit(rows, px, py)
        alpha, z = hit["alpha"], hit["z"]
        emit = (valid[..., None] & (j[None, :, None] < nc[:, None, :])
                & (alpha >= ALPHA_MIN) & (z >= NEAR_PLANE))
        m = distortion_m(z)
        col = rows[..., 14:20, None]                                       # [T, C, 6, 1]
        cn = ((col[:, :, 0] * gc[:, None, 0] + col[:, :, 1] * gc[:, None, 1]
               + col[:, :, 2] * gc[:, None, 2]) + col[:, :, 3] * gn[:, None, 0]
              + col[:, :, 4] * gn[:, None, 1] + col[:, :, 5] * gn[:, None, 2])
        w = torch.zeros_like(alpha)
        drho = torch.zeros_like(alpha)
        dz = torch.zeros_like(alpha)
        for i in reversed(range(j.shape[0])):
            e, a, zi, mi = emit[:, i], alpha[:, i], z[:, i], m[:, i]
            one_minus = 1.0 - a
            t_before = torch.where(e, trans / one_minus, trans)
            wi = torch.where(e, a * t_before, zero)
            wmi = wi * mi
            a_bar = a_all - wi
            d_bar = d_all - wmi
            d2_bar = d2_all - wmi * mi
            psi = mi * mi * a_bar + d2_bar - 2.0 * mi * d_bar
            uu = cn[:, i] + zi * gd + gdist * psi
            dalpha = torch.where(e, t_before * uu - (suffix + gt_term) / one_minus, zero)
            izm = 1.0 / torch.clamp_min(zi, 1e-6)
            dzi = wi * gd + gdist * 2.0 * wi * (mi * a_bar - d_bar) * (FFN * izm * izm)
            dzi = dzi + torch.where(e & (c0 + i + 1 == nm), gmed, zero)
            w[:, i] = wi
            drho[:, i] = -0.5 * hit["alpha_u"][:, i] * dalpha
            dz[:, i] = torch.where(e, dzi, zero)
            suffix = suffix + wi * uu
            trans = t_before
        u, v, use3d = hit["u"], hit["v"], hit["use3d"]
        du = torch.where(use3d, 2.0 * u * drho + rows[..., 9:10] * dz, zero)
        dv = torch.where(use3d, 2.0 * v * drho + rows[..., 10:11] * dz, zero)
        du = torch.where((hit["u_raw"] >= -1e3) & (hit["u_raw"] <= 1e3), du, zero)
        dv = torch.where((hit["v_raw"] >= -1e3) & (hit["v_raw"] <= 1e3), dv, zero)
        sz = hit["sz"]
        dsx = du / sz
        dsy = dv / sz
        dsz = torch.where(hit["s_z"].abs() > 1e-9, -(u * du + v * dv) / sz, zero)
        pxc, pyc = px[:, None, :], py[:, None, :]
        two_f = 2.0 * FILTER_INV_SQUARE
        grads = torch.stack([
            (dsx * pxc).sum(-1), (dsx * pyc).sum(-1), dsx.sum(-1),
            (dsy * pxc).sum(-1), (dsy * pyc).sum(-1), dsy.sum(-1),
            (dsz * pxc).sum(-1), (dsz * pyc).sum(-1), dsz.sum(-1),
            torch.where(use3d, u * dz, zero).sum(-1),
            torch.where(use3d, v * dz, zero).sum(-1),
            dz.sum(-1),
            torch.where(use3d, zero, two_f * hit["dx"] * drho).sum(-1),
            torch.where(use3d, zero, two_f * hit["dy"] * drho).sum(-1),
            (w * gc[:, None, 0]).sum(-1), (w * gc[:, None, 1]).sum(-1),
            (w * gc[:, None, 2]).sum(-1),
            (w * gn[:, None, 0]).sum(-1), (w * gn[:, None, 1]).sum(-1),
            (w * gn[:, None, 2]).sum(-1),
            (-2.0 * LN2) * drho.sum(-1),
        ], dim=-1)                                                         # [T, C, 21]
        d_table.index_add_(0, gid[idx[valid]].to(torch.int64), grads[valid])
    return d_table


def surfel_backward(data, gid, tile_start, tile_count, bg, g_color, g_alpha, g_depth,
                    g_normal, g_median, g_dist, t_final, n_contrib, n_med, wm, wm2,
                    n_rows: int, *, tiles_x: int):
    """K6 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `surfel_backward_plain` for CPU tensors.

    data [K, 21] f32, the stream K5 read; gid [K] int32 surfel row of each
    slot; tile_start/tile_count [T] int32; bg [3] f32; g_color and g_normal
    [T,3,256], g_alpha/g_depth/g_median/g_dist [T,1,256] f32, the cotangents
    of K5's outputs; K5's residuals t_final, wm, wm2 [T,1,256] f32 and
    n_contrib, n_med [T,1,256] int32. Returns d_table [n_rows, 21] f32, the
    gradient of the per-surfel table."""
    args = (data, gid, tile_start, tile_count, bg, g_color, g_alpha, g_depth, g_normal,
            g_median, g_dist, t_final, n_contrib, n_med, wm, wm2)
    dev = data.device
    if dev.type == "cpu":
        return surfel_backward_plain(*args, n_rows, tiles_x=tiles_x)
    if dev.type != "cuda":
        raise ValueError(f"surfel_backward supports cpu and cuda tensors, not {dev}")
    n_tiles = tile_start.shape[0]
    check_tensor(data, "data", torch.float32, (data.shape[0], SURFEL_COLS), dev)
    check_tensor(gid, "gid", torch.int32, (data.shape[0],), dev)
    check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,), dev)
    check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,), dev)
    check_tensor(bg, "bg", torch.float32, (3,), dev)
    for name, x in (("g_color", g_color), ("g_normal", g_normal)):
        check_tensor(x, name, torch.float32, (n_tiles, 3, PIXELS), dev)
    for name, x in (("g_alpha", g_alpha), ("g_depth", g_depth), ("g_median", g_median),
                    ("g_dist", g_dist), ("t_final", t_final), ("wm", wm), ("wm2", wm2)):
        check_tensor(x, name, torch.float32, (n_tiles, 1, PIXELS), dev)
    for name, x in (("n_contrib", n_contrib), ("n_med", n_med)):
        check_tensor(x, name, torch.int32, (n_tiles, 1, PIXELS), dev)
    if n_tiles == 0 or tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"bad tile grid: {n_tiles} tiles, {tiles_x} per row")
    if n_rows <= 0:
        raise ValueError(f"bad row count {n_rows}")

    lib = load("surfel_backward")
    d_table = torch.zeros(n_rows, SURFEL_COLS, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_surfel_backward(*(x.data_ptr() for x in args), d_table.data_ptr(),
                                        n_tiles, tiles_x, stream)
    if err != 0:
        raise RuntimeError(f"surfel backward kernel launch failed: cudaError {err}")
    surfel_backward.launches += 1
    return d_table


surfel_backward.launches = 0
