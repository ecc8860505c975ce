"""Kernels K4 and K5: the surfel forward compositor, a front-to-back blend
of the 7-channel allmap per 16x16 tile.

K4 (`surfel_composite`) is the eval compositor, the counterpart of
`scorp_tpu/ops/raster/pallas_surfel.py` (`_surfel_fwd_kernel`, entered
through `_surfel_kernel_call`). K5 (`surfel_composite_train`) is the same
blend with the residuals the backward compositor K6 walks back from, the
counterpart of `pallas_surfel_train.py` (`_surfel_train_fwd_kernel`,
entered through `_surfel_train_fwd_call`). Both are one templated CUDA body
in `csrc/surfel_composite.cu`; `surfel_composite_plain` below is the same
blend in PyTorch over key chunks of all tiles at once.

Numerics contract (`surfel.py` states the per-(pixel, key) math and the
distortion form): per pixel, keys are visited in stream order; keys with
alpha < 1/255 or z < 0.2 are skipped; a key is included iff
T·(1 − alpha) >= 1e-4 and no earlier key of the pixel crossed that
threshold (the crossing key is excluded and the pixel is done). Outputs per
tile: color + T·bg, alpha = 1 − T, Σw·z, Σw·normal, the median depth and the
distortion; K5 adds n_contrib (1-based stream position, from the tile
start, of the last included key), n_med (that of the median key, 0 if
none), Σw·m, Σw·m² and the final transmittance T.
"""

from __future__ import annotations

import math

import torch

from ._build import check_tensor, load
from .composite import PIXELS, PLAIN_CHUNK, pixel_coords
from .surfel import (
    ALPHA_MAX,
    ALPHA_MIN,
    FF,
    FFN,
    FILTER_INV_SQUARE,
    NC,
    NEAR_PLANE,
    SURFEL_COLS,
    T_EPS,
)

REPLACES = "scorp_tpu/ops/raster/pallas_surfel.py:136 _surfel_fwd_kernel"
REPLACES_TRAIN = "scorp_tpu/ops/raster/pallas_surfel_train.py:131 _surfel_train_fwd_kernel"
SOURCE = "scorp_tpu_torch/csrc/surfel_composite.cu"
# surfel_pretest's constants, surfel_common.cuh's kLog2_255, kTwoLn2, kRhoMargin
PRETEST_LOG2_255 = math.log2(255.0)
PRETEST_TWO_LN2 = 2.0 * math.log(2.0)
PRETEST_MARGIN = 1e-3


def surfel_hit(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> dict:
    """Per (pixel, key) quantities of a chunk: rows [T, C, 21] stream rows,
    px/py [T, P] pixel coordinates -> [T, C, P] tensors, each evaluated by
    the kernels' expression in the kernels' order (so that float32 results
    agree bit for bit on the same device)."""
    x, y = px[:, None, :], py[:, None, :]

    def col(i):
        return rows[..., i:i + 1]

    sx = col(0) * x + col(1) * y + col(2)
    sy = col(3) * x + col(4) * y + col(5)
    s_z = col(6) * x + col(7) * y + col(8)
    sz = torch.where(s_z.abs() > 1e-9, s_z, 1e-9)
    u_raw = sx / sz
    v_raw = sy / sz
    u = torch.clamp(u_raw, -1e3, 1e3)
    v = torch.clamp(v_raw, -1e3, 1e3)
    rho3d = u * u + v * v
    dx = col(12) - x
    dy = col(13) - y
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    alpha_u = torch.exp2(NC * rho + col(20))
    alpha = torch.clamp_max(alpha_u, ALPHA_MAX)
    z = torch.where(use3d, u * col(9) + v * col(10) + col(11), col(11))
    return dict(s_z=s_z, sz=sz, u_raw=u_raw, v_raw=v_raw, u=u, v=v, use3d=use3d,
                dx=dx, dy=dy, alpha_u=alpha_u, alpha=alpha, z=z)


def surfel_pretest(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The kernels' division-free pre-test (`csrc/surfel_common.cuh:
    may_hit`) of a chunk, [T, C, P] bool: False only where `surfel_hit`'s
    alpha < 1/255. alpha_u = opacity·e^(−rho/2) reaches 1/255 only if
    rho <= r = 2·ln2·(lopa + log2 255) (plus a 1e-3 margin), so only if
    rho2d <= r or sx² + sy² <= r·sz² (a clipped |u| of 1e3 gives
    rho3d >= 1e6 > r for opacity <= 1). A NaN passes. The kernels run it
    before `surfel_hit`'s divisions and skip a key for a warp in which no
    lane passes; the plain versions need no skip, so only the tests and
    chip_smoke.py's slot counts use this mirror."""
    x, y = px[:, None, :], py[:, None, :]

    def col(i):
        return rows[..., i:i + 1]

    sx = col(0) * x + col(1) * y + col(2)
    sy = col(3) * x + col(4) * y + col(5)
    s_z = col(6) * x + col(7) * y + col(8)
    sz = torch.where(s_z.abs() > 1e-9, s_z, 1e-9)
    dx = col(12) - x
    dy = col(13) - y
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    r = (col(20) + PRETEST_LOG2_255) * PRETEST_TWO_LN2 + PRETEST_MARGIN
    return ~(rho2d > r) | ~(sx * sx + sy * sy > r * (sz * sz))


def surfel_warp_mask(rows: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """The kernels' per-warp mask (`csrc/surfel_common.cuh:warp_mask`) of a
    chunk: rows [T, C, 21] f32 and the tiles' pixel origins x0/y0 [T] ->
    [T, C, 8] bool, False only where `surfel_pretest` is False at every
    pixel of the warp's two rows (x0..x0+15, y0+2w and y0+2w+1). The same
    f32 interval bounds as the CUDA function, op for op; like
    `surfel_pretest`, only the tests and chip_smoke.py's slot counts use it."""
    slack = 2.0 ** -18
    f32 = dict(dtype=torch.float32, device=rows.device)

    def col(i):
        return rows[..., i, None]                                          # [T, C, 1]

    fx0 = x0.to(**f32)[:, None, None]                                      # [T, 1, 1]
    xm, xmax = fx0 + 7.5, fx0 + 15.0
    ymax_tile = y0.to(**f32)[:, None, None] + 15.0
    s = [col(3 * k).abs() * xmax + col(3 * k + 1).abs() * ymax_tile + col(3 * k + 2).abs()
         for k in range(3)]
    cx, cy = col(12), col(13)
    sane = ((s[0] <= 1e18) & (s[1] <= 1e18) & (s[2] <= 1e18) & (cx.abs() <= 1e18)
            & (cy.abs() <= 1e18))
    r = (col(20) + PRETEST_LOG2_255) * PRETEST_TWO_LN2 + PRETEST_MARGIN
    ddx = torch.clamp_min(torch.maximum(fx0 - cx, cx - xmax), 0.0)
    ya = (y0[:, None] + 2 * torch.arange(8, device=rows.device)).to(**f32)[:, None, :]
    ym = ya + 0.5                                                          # [T, 1, 8]
    lo, hi = [], []
    for k in range(3):
        a, b = col(3 * k), col(3 * k + 1)
        mid = a * xm + b * ym + col(3 * k + 2)
        half = a.abs() * 7.5 + b.abs() * 0.5 + slack * s[k]
        lo.append(mid - half)
        hi.append(mid + half)

    def min_square(lo_, hi_):
        return torch.where(lo_ > 0, lo_ * lo_, torch.where(hi_ < 0, hi_ * hi_, 0.0))

    lhs = min_square(lo[0], hi[0]) + min_square(lo[1], hi[1])
    lhs = torch.where(lhs < 1e-30, 0.0, lhs)
    sz2 = torch.clamp_min(torch.maximum(lo[2] * lo[2], hi[2] * hi[2]), 1e-18)
    far3 = lhs * (1.0 - slack) > r * sz2 * (1.0 + slack)
    ddy = torch.clamp_min(torch.maximum(ya - cy, cy - (ya + 1.0)), 0.0)
    rho2 = FILTER_INV_SQUARE * (ddx * ddx + ddy * ddy)
    rho2 = torch.where(rho2 < 1e-30, 0.0, rho2)
    far2 = rho2 * (1.0 - slack) > r
    return ~(far3 & far2) | ~sane


def distortion_m(z: torch.Tensor) -> torch.Tensor:
    """m = FF − (FF·NEAR)/max(z, 1e-6), the (0.2, 100) NDC-mapped depth."""
    return FF - FFN / torch.clamp_min(z, 1e-6)


def surfel_composite_plain(data: torch.Tensor, tile_start: torch.Tensor,
                           tile_count: torch.Tensor, bg: torch.Tensor, *, tiles_x: int,
                           train: bool = False):
    """Plain PyTorch version of K4 (train=False) and K5 (train=True), same
    arguments and outputs. Per-(pixel, key) geometry is evaluated for a chunk
    of keys of every tile at once; the blend then advances key by key, in the
    kernels' order. It computes in `data`'s dtype, and autograd runs
    through it (out-of-place updates); its gradient stops at the 0.99 clamp,
    where K6's passes through (the two agree wherever no alpha is
    clamped)."""
    dev, dt = data.device, data.dtype
    n_tiles = tile_start.shape[0]
    px, py = pixel_coords(n_tiles, tiles_x, dt, dev)                      # [T, P]

    def zeros(*shape, dtype=dt):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    trans = torch.ones(n_tiles, PIXELS, dtype=dt, device=dev)
    done = zeros(n_tiles, PIXELS, dtype=torch.bool)
    acc_c, acc_n = zeros(n_tiles, 3, PIXELS), zeros(n_tiles, 3, PIXELS)
    acc_d, med, dist = zeros(n_tiles, PIXELS), zeros(n_tiles, PIXELS), zeros(n_tiles, PIXELS)
    a_run, d_run, d2_run = zeros(n_tiles, PIXELS), zeros(n_tiles, PIXELS), zeros(n_tiles, PIXELS)
    last = zeros(n_tiles, PIXELS, dtype=torch.int32)
    n_med = zeros(n_tiles, PIXELS, dtype=torch.int32)
    zero = zeros(())

    max_count = int(tile_count.max()) if n_tiles else 0
    for c0 in range(0, max_count, PLAIN_CHUNK):
        j = torch.arange(c0, min(c0 + PLAIN_CHUNK, max_count), device=dev)
        valid = j[None, :] < tile_count[:, None]                           # [T, C]
        idx = (tile_start[:, None].to(torch.int64) + j[None, :]).clamp_max(data.shape[0] - 1)
        rows = data[idx]                                                   # [T, C, 21]
        hit = surfel_hit(rows, px, py)
        z = hit["z"]
        alpha = torch.where(valid[..., None] & (hit["alpha"] >= ALPHA_MIN)
                            & (z >= NEAR_PLANE), hit["alpha"], zero)
        m = distortion_m(z)
        for i in range(j.shape[0]):
            a, zi, mi = alpha[:, i], z[:, i], m[:, i]
            test = trans * (1.0 - a)
            live = ~done & (a > 0.0)
            stop = live & (test < T_EPS)
            inc = live & ~stop
            w = torch.where(inc, a * trans, zero)
            acc_c = acc_c + w[:, None, :] * rows[:, i, 14:17, None]
            acc_n = acc_n + w[:, None, :] * rows[:, i, 17:20, None]
            acc_d = acc_d + w * zi
            is_med = inc & (trans > 0.5)
            med = torch.where(is_med, zi, med)
            n_med = torch.where(is_med, c0 + i + 1, n_med)
            dist = dist + w * (mi * mi * a_run + d2_run - 2.0 * mi * d_run)
            wm = w * mi
            a_run = a_run + w
            d_run = d_run + wm
            d2_run = d2_run + wm * mi
            trans = torch.where(inc, test, trans)
            done = done | stop
            last = torch.where(inc, c0 + i + 1, last)
        if bool(done.all()):
            break

    color = acc_c + trans[:, None, :] * bg[None, :, None]
    out = (color, (1.0 - trans)[:, None], acc_d[:, None], acc_n, med[:, None], dist[:, None])
    if not train:
        return out
    return out + (last[:, None], n_med[:, None], d_run[:, None], d2_run[:, None],
                  trans[:, None])


def _launch(fn_name: str, data, tile_start, tile_count, bg, tiles_x: int, train: bool):
    dev = data.device
    n_tiles = tile_start.shape[0]
    check_tensor(data, "data", torch.float32, (data.shape[0], SURFEL_COLS), dev)
    check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,), dev)
    check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,), dev)
    check_tensor(bg, "bg", torch.float32, (3,), dev)
    if n_tiles == 0 or tiles_x <= 0 or n_tiles % tiles_x:
        raise ValueError(f"bad tile grid: {n_tiles} tiles, {tiles_x} per row")

    lib = load("surfel_composite")

    def empty(c, dtype=torch.float32):
        return torch.empty(n_tiles, c, PIXELS, dtype=dtype, device=dev)

    outs = [empty(3), empty(1), empty(1), empty(3), empty(1), empty(1)]
    if train:
        outs += [empty(1, torch.int32), empty(1, torch.int32), empty(1), empty(1), empty(1)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            data.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), bg.data_ptr(),
            n_tiles, tiles_x, *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    return tuple(outs)


def surfel_composite(data: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                     bg: torch.Tensor, *, tiles_x: int):
    """K4 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `surfel_composite_plain` for CPU tensors.

    data [K, 21] f32 stream rows; tile_start/tile_count [T] int32; bg [3]
    f32. Returns (color [T,3,256], alpha [T,1,256], depth [T,1,256], normal
    [T,3,256], median [T,1,256], distortion [T,1,256]), pixels row-major in
    each tile."""
    dev = data.device
    if dev.type == "cpu":
        return surfel_composite_plain(data, tile_start, tile_count, bg, tiles_x=tiles_x)
    if dev.type != "cuda":
        raise ValueError(f"surfel_composite supports cpu and cuda tensors, not {dev}")
    out = _launch("scorp_surfel_composite", data, tile_start, tile_count, bg, tiles_x, False)
    surfel_composite.launches += 1
    return out


def surfel_composite_train(data: torch.Tensor, tile_start: torch.Tensor,
                           tile_count: torch.Tensor, bg: torch.Tensor, *, tiles_x: int):
    """K5 wrapper: K4's outputs followed by the residuals n_contrib and
    n_med [T,1,256] int32, Σw·m, Σw·m² and T_final [T,1,256] f32. Launches
    the CUDA kernel for CUDA tensors (and raises if that fails); runs
    `surfel_composite_plain(train=True)` for CPU tensors."""
    dev = data.device
    if dev.type == "cpu":
        return surfel_composite_plain(data, tile_start, tile_count, bg, tiles_x=tiles_x,
                                      train=True)
    if dev.type != "cuda":
        raise ValueError(f"surfel_composite_train supports cpu and cuda tensors, not {dev}")
    out = _launch("scorp_surfel_composite_train", data, tile_start, tile_count, bg, tiles_x,
                  True)
    surfel_composite_train.launches += 1
    return out


surfel_composite.launches = 0
surfel_composite_train.launches = 0
