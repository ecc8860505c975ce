"""Kernel K2: the forward compositor, a front-to-back blend per 16x16 tile.

Counterpart of `scorp_tpu/ops/raster/pallas_fwd.py` (`_fwd_kernel`,
entered through `_composite_kernel_call`). The CUDA source is
`csrc/composite.cu`; `composite_plain` below is the same blend in PyTorch
over key chunks of all tiles at once.

Numerics contract (shared with the JAX package): per pixel, keys are
visited in stream order; alpha = min(0.99, 2^(lopa - (u^2+v^2)/2)) with
u = l11 dx + l21 dy, v = l22 dy the sqrt(log2 e)-scaled Cholesky rows; keys
with alpha < 1/255 are skipped; a key is included iff T·(1-alpha) >= 1e-4
and no earlier key of the pixel crossed that threshold (the crossing key is
excluded and the pixel is done). Outputs per tile: color + T·bg, Σw·z,
alpha = 1 - T and, when asked, n_contrib = the 1-based stream position
(from the tile start) of the last included key and t_final = T itself, the
residual the backward compositor (K3, `backward.py`) walks back from.

`gauss_alpha` and `gauss_warp_mask` mirror the kernels' shared alpha
expression and per-warp skip (`csrc/gauss_common.cuh`) for the tests and
chip_smoke.py's slot counts; the plain versions need no skip.
"""

from __future__ import annotations

import math

import torch

from .._build import check_tensor, load
from .common import ALPHA_MAX, ALPHA_MIN, DATA_ROWS, T_EPS, TILE

REPLACES = "scorp_tpu/ops/raster/pallas_fwd.py:415 _fwd_kernel"
SOURCE = "scorp_tpu_torch/csrc/composite.cu"
PIXELS = TILE * TILE
PLAIN_CHUNK = 32  # keys per vectorized alpha evaluation in composite_plain
# gauss_warp_mask's constants, gauss_common.cuh's kLog2_255 and kQMargin
MASK_LOG2_255 = math.log2(255.0)
MASK_MARGIN = 1e-3


def pixel_coords(n_tiles: int, tiles_x: int, dtype, device):
    """[T, 256] pixel x and y of every tile's pixels, row-major in the tile."""
    t = torch.arange(n_tiles, device=device)
    pix = torch.arange(PIXELS, device=device)
    px = ((t % tiles_x)[:, None] * TILE + pix % TILE).to(dtype)
    py = ((t // tiles_x)[:, None] * TILE + pix // TILE).to(dtype)
    return px, py


def gauss_alpha(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> dict:
    """Per (pixel, key) quantities of a chunk: rows [T, C, 10] stream rows,
    px/py [T, P] pixel coordinates -> [T, C, P] tensors dx, dy, u, v,
    alpha_u and alpha, by the kernels' expression (`csrc/gauss_common.cuh:
    alpha_of`) in the kernels' order, so that float32 results agree bit for
    bit on the same device."""
    dx = rows[..., 0:1] - px[:, None, :]
    dy = rows[..., 1:2] - py[:, None, :]
    u = rows[..., 2:3] * dx + rows[..., 3:4] * dy
    v = rows[..., 4:5] * dy
    alpha_u = torch.exp2(-0.5 * (u * u + v * v) + rows[..., 9:10])
    return dict(dx=dx, dy=dy, u=u, v=v, alpha_u=alpha_u,
                alpha=torch.clamp_max(alpha_u, ALPHA_MAX))


def gauss_warp_mask(rows: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """The kernels' per-warp mask (`csrc/gauss_common.cuh:warp_mask`) of a
    chunk: rows [T, C, 10] f32 and the tiles' pixel origins x0/y0 [T] ->
    [T, C, 8] bool, False only where `gauss_alpha`'s alpha < 1/255 at every
    pixel of the warp's two rows (x0..x0+15, y0+2w and y0+2w+1). u and v are
    affine in the pixel: each lies within its centre value +- slope times
    half-extent, widened by 2^-18 of its terms' magnitudes; the lower bound
    of u² + v² is compared with the radius 2·(lopa + log2 255) + 1e-3 with
    2^-18 of relative slack. The same f32 operations as the CUDA function,
    op for op."""
    slack = 2.0 ** -18
    f32 = dict(dtype=torch.float32, device=rows.device)

    def col(i):
        return rows[..., i, None]                                          # [T, C, 1]

    def min_square(lo, hi):
        return torch.where(lo > 0, lo * lo, torch.where(hi < 0, hi * hi, 0.0))

    lopa = col(9)
    r = (lopa + MASK_LOG2_255) * 2.0 + MASK_MARGIN
    a11, a21, a22 = col(2).abs(), col(3).abs(), col(4).abs()
    dxm = col(0) - (x0.to(**f32)[:, None, None] + 7.5)
    adx = dxm.abs() + 7.5
    ya = (y0[:, None] + 2 * torch.arange(8, device=rows.device)).to(**f32)[:, None, :]
    dym = col(1) - (ya + 0.5)                                              # [T, C, 8]
    ady = dym.abs() + 0.5
    su = a11 * adx + a21 * ady
    sv = a22 * ady
    um = col(2) * dxm + col(3) * dym
    hu = a11 * 7.5 + a21 * 0.5 + slack * su
    vm = col(4) * dym
    hv = a22 * 0.5 + slack * sv
    q = min_square(um - hu, um + hu) + min_square(vm - hv, vm + hv)
    q = torch.where(q < 1e-30, 0.0, q)
    far = q * (1.0 - slack) > r * (1.0 + slack)
    sane = (lopa.abs() <= 1e18) & (su <= 1e18) & (sv <= 1e18)
    return ~far | ~sane


def composite_plain(data: torch.Tensor, tile_start: torch.Tensor,
                    tile_count: torch.Tensor, bg: torch.Tensor, *, tiles_x: int,
                    track_ncontrib: bool = False, with_t_final: bool = False):
    """Plain PyTorch version of the kernel, same arguments and outputs.
    Alphas are evaluated for a chunk of keys of every tile at once; the
    transmittance then advances key by key, in the kernel's order. It
    computes in `data`'s dtype (float64 serves as a reference), and autograd
    runs through it; its gradient stops at the 0.99 clamp, where K3's passes
    through (the two agree wherever no alpha is clamped)."""
    dev, dt = data.device, data.dtype
    n_tiles = tile_start.shape[0]
    px, py = pixel_coords(n_tiles, tiles_x, dt, dev)                      # [T, P]

    trans = torch.ones(n_tiles, PIXELS, dtype=dt, device=dev)
    done = torch.zeros(n_tiles, PIXELS, dtype=torch.bool, device=dev)
    acc = torch.zeros(n_tiles, 3, PIXELS, dtype=dt, device=dev)
    acc_d = torch.zeros(n_tiles, PIXELS, dtype=dt, device=dev)
    last = torch.zeros(n_tiles, PIXELS, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    max_count = int(tile_count.max()) if n_tiles else 0
    for c0 in range(0, max_count, PLAIN_CHUNK):
        j = torch.arange(c0, min(c0 + PLAIN_CHUNK, max_count), device=dev)
        valid = j[None, :] < tile_count[:, None]                           # [T, C]
        idx = (tile_start[:, None].to(torch.int64) + j[None, :]).clamp_max(data.shape[0] - 1)
        rows = data[idx]                                                   # [T, C, 10]
        dx = rows[..., 0:1] - px[:, None, :]                               # [T, C, P]
        dy = rows[..., 1:2] - py[:, None, :]
        u = rows[..., 2:3] * dx + rows[..., 3:4] * dy
        v = rows[..., 4:5] * dy
        power = -0.5 * (u * u + v * v)
        alpha = torch.clamp_max(torch.exp2(power + rows[..., 9:10]), ALPHA_MAX)
        alpha = torch.where(valid[..., None] & (alpha >= ALPHA_MIN), alpha, zero)
        for i in range(j.shape[0]):
            a = alpha[:, i]
            test = trans * (1.0 - a)
            live = ~done & (a > 0.0)
            stop = live & (test < T_EPS)
            inc = live & ~stop
            w = torch.where(inc, a * trans, zero)
            acc += w[:, None, :] * rows[:, i, 5:8, None]
            acc_d += w * rows[:, i, 8:9]
            trans = torch.where(inc, test, trans)
            done |= stop
            last = torch.where(inc, c0 + i + 1, last)
        if bool(done.all()):
            break

    color = acc + trans[:, None, :] * bg[None, :, None]
    out = (color, acc_d[:, None], (1.0 - trans)[:, None],
           last[:, None] if track_ncontrib else None)
    return out + (trans[:, None],) if with_t_final else out


def composite(data: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
              bg: torch.Tensor, *, tiles_x: int, track_ncontrib: bool = False,
              with_t_final: bool = False):
    """K2 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `composite_plain` for CPU tensors.

    data [K, 10] f32 stream rows; tile_start/tile_count [T] int32; bg [3]
    f32. Returns (color [T,3,256], depth [T,1,256], alpha [T,1,256],
    n_contrib [T,1,256] int32 or None) with pixels row-major in each tile,
    and with `with_t_final` a fifth output, the final transmittance
    [T,1,256] f32.
    """
    dev = data.device
    if dev.type == "cpu":
        return composite_plain(data, tile_start, tile_count, bg, tiles_x=tiles_x,
                               track_ncontrib=track_ncontrib, with_t_final=with_t_final)
    if dev.type != "cuda":
        raise ValueError(f"composite supports cpu and cuda tensors, not {dev}")
    n_tiles = tile_start.shape[0]
    check_tensor(data, "data", torch.float32, (data.shape[0], DATA_ROWS), dev)
    check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,), dev)
    check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,), dev)
    check_tensor(bg, "bg", torch.float32, (3,), dev)
    if data.data_ptr() % 8:  # K2 copies rows in 8-byte pieces
        raise ValueError("data must start at an 8-byte aligned address")
    if n_tiles == 0 or tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"bad tile grid: {n_tiles} tiles, {tiles_x} per row")

    lib = load("composite")
    color = torch.empty(n_tiles, 3, PIXELS, device=dev)
    depth = torch.empty(n_tiles, 1, PIXELS, device=dev)
    alpha = torch.empty(n_tiles, 1, PIXELS, device=dev)
    n_contrib = (torch.empty(n_tiles, 1, PIXELS, dtype=torch.int32, device=dev)
                 if track_ncontrib else None)
    t_final = torch.empty(n_tiles, 1, PIXELS, device=dev) if with_t_final else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_composite(
            data.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            bg.data_ptr(), n_tiles, tiles_x,
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
            n_contrib.data_ptr() if n_contrib is not None else None,
            t_final.data_ptr() if t_final is not None else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite kernel launch failed: cudaError {err}")
    composite.launches += 1
    out = (color, depth, alpha, n_contrib)
    return out + (t_final,) if with_t_final else out


composite.launches = 0
