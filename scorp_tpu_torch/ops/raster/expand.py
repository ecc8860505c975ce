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
and low-pass circle), and writes the packed sort key (tile << bits_g) | g,
or the sentinel num_tiles << bits_g for culled keys and keys at or past
min(total, k_cap). `kept` counts the live keys. The key is int32 where it
fits, as the JAX package packs it (`common.key_dtype`), else int64.

The key buffer follows the frame, not the capacity: `expand_inputs` reads
`total` to the host once and K1 writes `key_slots(total, k_cap)` slots,
`total` rounded up to a whole bucket of SLOT_BUCKET slots and at most
k_cap. Every live key lies below min(total, k_cap), so the slots past it
would hold only sentinels; the capacity still decides what is dropped.

The kernel finds each slot's gaussian by a search per block of
`BLOCK_SLOTS` slots (`csrc/expand.cu`); `warp_search_plain` and
`block_search_plain` mirror that search in PyTorch for the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.trace import span
from .._build import check_tensor, load
from .common import (
    TILE,
    Routable,
    default_cull_geo,
    depth_order,
    edge_min_q,
    grid_dims,
    key_dtype,
    key_routing,
    pack_bits,
)

REPLACES = "scorp_tpu/ops/raster/pallas_expand.py:80 _expand_kernel"
SOURCE = "scorp_tpu_torch/csrc/expand.cu"
BLOCK_SLOTS = 1024  # key slots per block of the kernel (csrc/expand.cu: kBlockSlots)
SLOT_BUCKET = 1 << 18  # the key buffer's length is a whole number of these, or k_cap


def key_slots(total: int, k_cap: int) -> int:
    """Length of the key buffer for a frame of `total` expanded keys: total
    rounded up to a whole bucket, at least one bucket, at most k_cap. The
    bucket bounds the distinct lengths (128 at k_cap = 2^25), so the sort's
    scratch query (`sort._temp_bytes`) and the allocator's blocks do not
    grow frame by frame."""
    return min(k_cap, -(-max(total, 1) // SLOT_BUCKET) * SLOT_BUCKET)


class ExpandInputs(NamedTuple):
    starts: torch.Tensor        # [N] int32 exclusive prefix of tile counts, clamped to k_cap
    limit: torch.Tensor         # [1] int32 min(total, k_cap)
    rect: torch.Tensor          # [N, 4] int32 depth-sorted rects (x0, y0, x1, y1)
    geo: torch.Tensor | None    # [N, 6] f32 depth-sorted cull ellipses; None = no cull
    geo2: torch.Tensor | None   # [N, 6] f32 depth-sorted second ellipses (union); or None
    k_cap: int
    slots: int                  # length of the key buffer: key_slots(total, k_cap)
    tiles_x: int
    num_tiles: int
    bits_g: int
    key_dtype: torch.dtype      # torch.int32 or torch.int64 (common.key_dtype)
    end_bit: int                # bit length of the sentinel: the sort's bits
    order: torch.Tensor         # [N] depth order (not read by the kernel)
    total: torch.Tensor         # [] int64 keys before capacity (not read by the kernel)


def expand_inputs(prep: Routable, width: int, height: int, k_cap: int,
                  cull: bool, geo: torch.Tensor | None = None,
                  geo2: torch.Tensor | None = None) -> ExpandInputs:
    """The depth sort and prefix sums around the kernel (plain torch), and
    the key buffer's length from `total`, read to the host (the routing's
    one synchronisation). With `cull`, the cull ellipses are `geo`
    (default: the 3DGS ellipse, `default_cull_geo`) and the optional `geo2`,
    both [N, 6] in the prep's order."""
    n = prep.xy.shape[0]
    if n == 0:
        raise ValueError("key expansion needs at least one gaussian")
    tiles_x, tiles_y = grid_dims(width, height)
    num_tiles = tiles_x * tiles_y
    bits_g = pack_bits(n)
    order = depth_order(prep)
    rect = prep.rect[order].contiguous()
    _, _, _, _, starts, total = key_routing(rect)
    if cull:
        geo = (default_cull_geo(prep) if geo is None else geo)[order].contiguous()
        geo2 = None if geo2 is None else geo2[order].contiguous()
    else:
        geo = geo2 = None
    starts = torch.clamp_max(starts, k_cap).to(torch.int32)
    limit = torch.clamp_max(total, k_cap).to(torch.int32).reshape(1)
    # the read waits for the device: launch all that does not need it first
    with span("sync.route_total"):
        total_keys = int(total)
    slots = key_slots(total_keys, k_cap)
    return ExpandInputs(
        starts=starts,
        limit=limit,
        rect=rect,
        geo=geo,
        geo2=geo2,
        k_cap=k_cap,
        slots=slots,
        tiles_x=tiles_x,
        num_tiles=num_tiles,
        bits_g=bits_g,
        key_dtype=key_dtype(n, num_tiles),
        end_bit=(num_tiles << bits_g).bit_length(),
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
    """Plain PyTorch version of the kernel: (keys [slots] of x.key_dtype,
    kept [1] int32)."""
    dev = x.starts.device
    n = x.starts.shape[0]
    ks = torch.arange(x.slots, dtype=torch.int32, device=dev)
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
    return keys.to(x.key_dtype), live.sum(dtype=torch.int32).reshape(1)


def warp_search_plain(starts: torch.Tensor, k: int) -> int:
    """The kernel's 32-way search (`csrc/expand.cu:warp_search`): the last g
    with starts[g] <= k, one probe per lane and round (tests only)."""
    lo, hi = 0, starts.shape[0] - 1
    lanes = torch.arange(1, 33, dtype=torch.int64)
    while lo < hi:
        p = lo + ((lanes * (hi - lo)) >> 5)
        c = int((starts[p] <= k).sum())
        if c == 32:
            return hi
        if c > 0:
            lo = int(p[c - 1])
        hi = int(p[c]) - 1
    return lo


def block_search_plain(starts: torch.Tensor, limit: int, k_cap: int):
    """The kernel's search per block of BLOCK_SLOTS slots, in PyTorch (tests
    only), on K1's `starts` and `limit`: (owner [k_cap] int64, the gaussian
    of every slot below limit and -1 from there; g_lo, g_hi [blocks] int64,
    each block's first and last gaussian, -1 for a block wholly past
    limit). Per block with live slots [b0, e): g_lo and g_hi by
    `warp_search_plain` at b0 and e - 1, a mark at starts[g] - b0 holding
    the largest such g of (g_lo, g_hi], and a max-scan of the marks floored
    at g_lo."""
    starts = starts.to(torch.int64)
    lim = int(limit)
    blocks = -(-k_cap // BLOCK_SLOTS)
    owner = torch.full((k_cap,), -1, dtype=torch.int64)
    g_lo = torch.full((blocks,), -1, dtype=torch.int64)
    g_hi = torch.full((blocks,), -1, dtype=torch.int64)
    for b in range(blocks):
        b0 = b * BLOCK_SLOTS
        if b0 >= lim:
            continue
        e = min(lim, b0 + BLOCK_SLOTS)
        lo, hi = warp_search_plain(starts, b0), warp_search_plain(starts, e - 1)
        g_lo[b], g_hi[b] = lo, hi
        mark = torch.zeros(BLOCK_SLOTS, dtype=torch.int64)
        g = torch.arange(lo + 1, hi + 1)
        mark.scatter_reduce_(0, starts[g] - b0, g, reduce="amax")
        owner[b0:e] = torch.cummax(torch.clamp_min(mark, lo), 0).values[:e - b0]
    return owner, g_lo, g_hi


def expand_keys(x: ExpandInputs):
    """K1 wrapper: launches the CUDA kernel for CUDA tensors (and raises if
    that fails); runs `expand_keys_plain` for CPU tensors.
    Returns (keys [slots] of x.key_dtype, unsorted; kept [1] int32)."""
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
    if n == 0 or not 0 < x.slots <= x.k_cap <= 1 << 30:
        raise ValueError(f"bad sizes: n={n}, slots={x.slots}, k_cap={x.k_cap}")
    if x.key_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"key_dtype {x.key_dtype}, expected torch.int32 or torch.int64")
    if x.num_tiles << x.bits_g >= 1 << (31 if x.key_dtype == torch.int32 else 63):
        raise ValueError(f"{x.num_tiles} tiles << {x.bits_g} bits overflow {x.key_dtype} keys")
    if x.rect.data_ptr() % 16:
        raise ValueError("rect must be 16-byte aligned (read as int4)")

    lib = load("expand")
    keys = torch.empty(x.slots, dtype=x.key_dtype, device=dev)
    kept = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_expand_keys(
            x.starts.data_ptr(), x.limit.data_ptr(), x.rect.data_ptr(),
            x.geo.data_ptr() if x.geo is not None else None,
            x.geo2.data_ptr() if x.geo2 is not None else None,
            n, x.slots, x.tiles_x, x.num_tiles, x.bits_g, int(x.key_dtype == torch.int64),
            keys.data_ptr(), kept.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"expand kernel launch failed: cudaError {err}")
    expand_keys.launches += 1
    return keys, kept


expand_keys.launches = 0

