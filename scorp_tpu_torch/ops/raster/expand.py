"""Kernel K1: key expansion with the exact ellipse-vs-tile cull.

Counterpart of `scorp_tpu/ops/raster/pallas_expand.py` (`_expand_kernel`,
entered through `expand_sorted_keys`). The CUDA source is
`csrc/expand.cu`; `expand_keys_plain` below is the same arithmetic
vectorized in PyTorch over all keys.

The depth argsort, the rect tile `counts`, their exclusive prefix sum
`starts` and `total` are plain torch (`expand_inputs`), as the JAX package
keeps them outside Pallas. Per key slot k < k_cap the kernel finds its
gaussian g (the last with starts[g] <= k), its tile inside g's rect, runs
the f32 alpha>=1/255 ellipse-vs-tile test on g's cull geometry
(cx, cy, A, B, C, t2) and, when there is one, on its second ellipse `geo2`
(a key is kept iff either admits its tile: the surfel path's UV-disc conic
and low-pass circle), and writes the int64 sort key (tile << bits_g) | g,
or the sentinel num_tiles << bits_g for culled keys and keys at or past
min(total, k_cap). `kept` counts the live keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import check_tensor, load
from .common import (
    TILE,
    Preprocessed,
    default_cull_geo,
    depth_order,
    edge_min_q,
    grid_dims,
    key_routing,
    pack_bits,
)

REPLACES = "scorp_tpu/ops/raster/pallas_expand.py:80 _expand_kernel"
SOURCE = "scorp_tpu_torch/csrc/expand.cu"


class ExpandInputs(NamedTuple):
    starts: torch.Tensor        # [N] int32 exclusive prefix of tile counts, clamped to k_cap
    limit: torch.Tensor         # [1] int32 min(total, k_cap)
    rect: torch.Tensor          # [N, 4] int32 depth-sorted rects (x0, y0, x1, y1)
    geo: torch.Tensor | None    # [N, 6] f32 depth-sorted cull ellipses; None = no cull
    geo2: torch.Tensor | None   # [N, 6] f32 depth-sorted second ellipses (union); or None
    k_cap: int
    tiles_x: int
    num_tiles: int
    bits_g: int
    order: torch.Tensor         # [N] depth order (not read by the kernel)
    total: torch.Tensor         # [] int64 keys before capacity (not read by the kernel)


def expand_inputs(prep: Preprocessed, width: int, height: int, k_cap: int,
                  cull: bool, geo: torch.Tensor | None = None,
                  geo2: torch.Tensor | None = None) -> ExpandInputs:
    """The depth sort and prefix sums around the kernel (plain torch). With
    `cull`, the cull ellipses are `geo` (default: the 3DGS ellipse,
    `default_cull_geo`) and the optional `geo2`, both [N, 6] in the prep's
    order."""
    n = prep.xy.shape[0]
    if n == 0:
        raise ValueError("key expansion needs at least one gaussian")
    tiles_x, tiles_y = grid_dims(width, height)
    order = depth_order(prep)
    rect = prep.rect[order].contiguous()
    _, _, _, _, starts, total = key_routing(rect)
    if cull:
        geo = (default_cull_geo(prep) if geo is None else geo)[order].contiguous()
        geo2 = None if geo2 is None else geo2[order].contiguous()
    else:
        geo = geo2 = None
    return ExpandInputs(
        starts=torch.clamp_max(starts, k_cap).to(torch.int32),
        limit=torch.clamp_max(total, k_cap).to(torch.int32).reshape(1),
        rect=rect,
        geo=geo,
        geo2=geo2,
        k_cap=k_cap,
        tiles_x=tiles_x,
        num_tiles=tiles_x * tiles_y,
        bits_g=pack_bits(n),
        order=order,
        total=total,
    )


def cull_keep_tight(q_min, qabs, pd, t2):
    """K1's keep rule on f32 geometry: the tolerance covers f32 association
    and contraction rounding only, so strictly more non-contributing keys are
    culled than by the golden (whose tolerance covers bf16 quantization)."""
    return ~pd | (q_min <= t2 + 4e-5 * qabs + 2e-3)


def _keep_plain(geo, g, tx, ty):
    gg = geo[g]
    fx = (tx * TILE).to(torch.float32)
    fy = (ty * TILE).to(torch.float32)
    cx, cy = gg[:, 0], gg[:, 1]
    q_min, qabs, pd = edge_min_q(
        fx - cx, fx + (TILE - 1) - cx, fy - cy, fy + (TILE - 1) - cy,
        gg[:, 2], gg[:, 3], gg[:, 4],
    )
    return cull_keep_tight(q_min, qabs, pd, gg[:, 5])


def expand_keys_plain(x: ExpandInputs):
    """Plain PyTorch version of the kernel: (keys [k_cap] int64, kept [1] int32)."""
    dev = x.starts.device
    n = x.starts.shape[0]
    ks = torch.arange(x.k_cap, dtype=torch.int32, device=dev)
    g = (torch.searchsorted(x.starts, ks, right=True) - 1).clamp(0, n - 1)
    r = x.rect[g]
    span = torch.clamp_min(r[:, 2] - r[:, 0], 1)
    local = ks - x.starts[g]
    qy = torch.div(local, span, rounding_mode="floor")
    tx = r[:, 0] + (local - qy * span)
    ty = r[:, 1] + qy
    live = ks < x.limit
    if x.geo is not None:
        keep = _keep_plain(x.geo, g, tx, ty)
        if x.geo2 is not None:
            keep = keep | _keep_plain(x.geo2, g, tx, ty)
        live = live & keep
    tile = (ty * x.tiles_x + tx).to(torch.int64)
    keys = torch.where(
        live,
        (tile << x.bits_g) | g.to(torch.int64),
        torch.full_like(tile, x.num_tiles << x.bits_g),
    )
    return keys, live.sum(dtype=torch.int32).reshape(1)


def expand_keys(x: ExpandInputs):
    """K1 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `expand_keys_plain` for CPU tensors.
    Returns (keys [k_cap] int64 unsorted, kept [1] int32)."""
    dev = x.starts.device
    if dev.type == "cpu":
        return expand_keys_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"expand_keys supports cpu and cuda tensors, not {dev}")
    n = x.starts.shape[0]
    check_tensor(x.starts, "starts", torch.int32, (n,), dev)
    check_tensor(x.limit, "limit", torch.int32, (1,), dev)
    check_tensor(x.rect, "rect", torch.int32, (n, 4), dev)
    if x.geo is not None:
        check_tensor(x.geo, "geo", torch.float32, (n, 6), dev)
    if x.geo2 is not None:
        if x.geo is None:
            raise ValueError("geo2 needs geo")
        check_tensor(x.geo2, "geo2", torch.float32, (n, 6), dev)
    if n == 0 or x.k_cap <= 0 or x.k_cap >= 1 << 31:
        raise ValueError(f"bad sizes: n={n}, k_cap={x.k_cap}")
    if x.rect.data_ptr() % 16:
        raise ValueError("rect must be 16-byte aligned (read as int4)")

    lib = load("expand")
    keys = torch.empty(x.k_cap, dtype=torch.int64, device=dev)
    kept = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_expand_keys(
            x.starts.data_ptr(), x.limit.data_ptr(), x.rect.data_ptr(),
            x.geo.data_ptr() if x.geo is not None else None,
            x.geo2.data_ptr() if x.geo2 is not None else None,
            n, x.k_cap, x.tiles_x, x.num_tiles, x.bits_g,
            keys.data_ptr(), kept.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"expand kernel launch failed: cudaError {err}")
    expand_keys.launches += 1
    return keys, kept


expand_keys.launches = 0

