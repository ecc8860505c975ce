"""Shared stages of the tile-based Gaussian rasterizer, torch port of
`scorp_tpu.ops.raster.common`.

preprocess — vectorized over N: projection with row-vector transposed
  matrices, EWA 2D covariance J·W·Σ·Wᵀ·Jᵀ with the 0.3 px low-pass
  dilation, frustum cull at view z <= 0.2, SH→RGB with the clamp-at-0 gate.
  Reported radii are the reference's (ceil of 3σ of the max eigenvalue);
  the *binning* rect is the exact per-axis alpha>=1/255 ellipse bbox min'd
  with the reference rect (every excluded pixel has zero contribution).
  `preprocess_plain` is the plain version, the one autograd runs through;
  `fused_preprocess.preprocess_kernel` computes it in one CUDA launch.

binning — instead of atomic key duplication + per-key radix sort:
  1. gaussians are sorted by view depth (one N-sized argsort);
  2. every key slot k finds its gaussian in the exclusive prefix
     sum `starts` of the rect tile counts, and its tile inside the rect
     (kernel K1, `expand.py`), culling keys whose tile the alpha>=1/255
     ellipse misses; the slots are the frame's expanded keys `total`
     rounded up to a bucket (`expand.key_slots`), at most max_keys;
  3. one keys-only sort of the packed (tile << bits_g) | depth_rank keys
     (`sort.py`; int32 keys where they fit, as the JAX package packs them,
     else int64) keeps depth order within each tile;
  4. per-tile ranges come from a searchsorted over the sorted tile ids.

`route_stream` gives the integer routing (the gaussian row of every
stream slot + per-tile start/count). Both rasterizers gather their
per-primitive table (`stream_table`, `surfel.surfel_table`) by it for the
compositors, and the grad path scatters the table's gradient back along it
(kernels K3, `backward.py`, and K6).

`_expand_keys_core` is the expansion golden: the same routing as K1, with
the JAX package's cull arithmetic (rect-relative 1/32 px fixed-point
centers, bf16 conic and threshold, the loose 2%+1%+0.9 tolerance), so its
kept count brackets K1's (0.8·golden ≤ K1 ≤ golden + 1000).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple, Union

import torch

from ...core import sh as sh_lib
from ...core.camera import Camera
from ...utils.trace import span

if TYPE_CHECKING:
    from .surfel import SurfelFrame, SurfelPrep

TILE = 16  # pixels per tile side
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
DATA_ROWS = 10  # stream row layout, see stream_table


class RasterConfig(NamedTuple):
    """Capacities of the key buffers."""

    # (gaussian, tile) pair capacity: a ceiling, past which keys are dropped;
    # the key buffers follow each frame's expanded keys (`expand.key_slots`)
    max_keys: int = 1 << 20
    # capacity of the post-cull sorted stream (0 = max_keys): the exact
    # ellipse-tile cull drops 15-50% of expanded keys, so the stream the
    # compositor reads can be smaller than the expansion buffer
    stream_keys: int = 0

    @property
    def stream_cap(self) -> int:
        return self.stream_keys or self.max_keys


class Preprocessed(NamedTuple):
    xy: torch.Tensor        # [N,2] pixel-space projected centers
    depth: torch.Tensor     # [N] view-space z
    conic: torch.Tensor     # [N,3] inverse 2D covariance (A, B, C)
    color: torch.Tensor     # [N,3] RGB (SH-evaluated or precomputed)
    opacity: torch.Tensor   # [N] activated opacity
    radii: torch.Tensor     # [N] int32 reference screen radius (0 = culled)
    rect: torch.Tensor      # [N,4] int32 binning tile rect (x0, y0, x1, y1), half-open
    valid: torch.Tensor     # [N] bool (has at least one binning tile)


class StreamRouting(NamedTuple):
    """Integer routing of the per-tile key stream: slot k of the stream
    holds the row gid[k] of the per-gaussian table (`stream_table`)."""

    gid: torch.Tensor          # [min(K2, slots)] int32 gaussian row of each stream slot
    tile_start: torch.Tensor   # [num_tiles] int32 offsets into the stream
    tile_count: torch.Tensor   # [num_tiles] int32
    num_dropped_keys: torch.Tensor  # [] int64


# A preprocess output that routing takes: it reads `depth`, `valid`, `rect`
# and the length of `xy`, and, where no cull ellipse is given, the 3DGS
# ellipse's fields `xy`, `conic` and `opacity` (`default_cull_geo`). The
# surfel path always gives its two ellipses.
Routable = Union[Preprocessed, "SurfelPrep", "SurfelFrame"]


def grid_dims(width: int, height: int) -> tuple[int, int]:
    return (-(-width // TILE), -(-height // TILE))


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor, modifier) -> torch.Tensor:
    """[N,3] scales (activated) + [N,4] quats -> [N,6] upper-tri covariance
    (Σ_ik = Σ_j R_ij R_kj s_j²)."""
    q = quats
    # clamp INSIDE the sqrt (see core.quat.quat_to_rotmat)
    norm = torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1), 1e-24))
    qn = q / norm[:, None]
    w, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s = scales * modifier
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([c00, c01, c02, c11, c12, c22], dim=-1)


def _tile_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(int32(v), 0, hi) with truncation toward zero. The float clamp
    first keeps out-of-range values (and NaN, which ends at 0) from an
    undefined float->int conversion; it changes no in-range result."""
    return torch.clamp(v, -1.0, hi + 1.0).to(torch.int32).clamp(0, hi)


def preprocess_plain(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    quats: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_deltas: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> Preprocessed:
    """Vectorized per-Gaussian projection/culling/color stage, the plain
    version of the fused kernel (`csrc/preprocess.cu`) and the only one
    autograd runs through.

    `screen_deltas` [N,2] is added to the projected NDC position (the
    reference's `screenspace_points` trick): its gradient is the NDC-scaled
    means2D gradient that densification reads."""
    n = means3d.shape[0]
    w, h = cam.width, cam.height
    tiles_x, tiles_y = grid_dims(w, h)

    px, py, pz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = cam.viewmatrix
    P = cam.projmatrix
    # row-vector transforms, scalarized
    view_x = px * V[0, 0] + py * V[1, 0] + pz * V[2, 0] + V[3, 0]
    view_y = px * V[0, 1] + py * V[1, 1] + pz * V[2, 1] + V[3, 1]
    depth = px * V[0, 2] + py * V[1, 2] + pz * V[2, 2] + V[3, 2]
    clip_x = px * P[0, 0] + py * P[1, 0] + pz * P[2, 0] + P[3, 0]
    clip_y = px * P[0, 1] + py * P[1, 1] + pz * P[2, 1] + P[3, 1]
    clip_w = px * P[0, 3] + py * P[1, 3] + pz * P[2, 3] + P[3, 3]
    p_w = 1.0 / (clip_w + 1e-7)
    ndc_x = clip_x * p_w
    ndc_y = clip_y * p_w
    in_front = depth > 0.2

    if screen_deltas is not None:
        ndc_x = ndc_x + screen_deltas[:, 0]
        ndc_y = ndc_y + screen_deltas[:, 1]
    # ndc2Pix: ((v + 1) * S - 1) * 0.5
    pix_x = (ndc_x + 1.0) * (w * 0.5) - 0.5
    pix_y = (ndc_y + 1.0) * (h * 0.5) - 0.5
    xy = torch.stack([pix_x, pix_y], dim=-1)

    # --- EWA 2D covariance (scalarized) ---
    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = compute_cov3d(scales, quats, scale_modifier)
    s00, s01, s02 = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    s11, s12, s22 = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    focal_x = w / (2.0 * cam.tanfovx)
    focal_y = h / (2.0 * cam.tanfovy)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    tz = torch.where(in_front, depth, one)  # safe divisor in culled lanes
    inv_z = 1.0 / tz
    tx = torch.clamp(view_x * inv_z, -limx, limx) * tz
    ty = torch.clamp(view_y * inv_z, -limy, limy) * tz

    # M = J @ R_w2c with J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]]
    # R_w2c rows are V's columns (V stores W2C transposed).
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z * inv_z
    r00, r01, r02 = V[0, 0], V[1, 0], V[2, 0]
    r10, r11, r12 = V[0, 1], V[1, 1], V[2, 1]
    r20, r21, r22 = V[0, 2], V[1, 2], V[2, 2]
    m00 = j00 * r00 + j02 * r20
    m01 = j00 * r01 + j02 * r21
    m02 = j00 * r02 + j02 * r22
    m10 = j11 * r10 + j12 * r20
    m11 = j11 * r11 + j12 * r21
    m12 = j11 * r12 + j12 * r22
    # cov2 = M Σ Mᵀ
    t0x = m00 * s00 + m01 * s01 + m02 * s02
    t0y = m00 * s01 + m01 * s11 + m02 * s12
    t0z = m00 * s02 + m01 * s12 + m02 * s22
    t1x = m10 * s00 + m11 * s01 + m12 * s02
    t1y = m10 * s01 + m11 * s11 + m12 * s12
    t1z = m10 * s02 + m11 * s12 + m12 * s22
    c00 = t0x * m00 + t0y * m01 + t0z * m02 + 0.3
    c01 = t1x * m00 + t1y * m01 + t1z * m02
    c11 = t1x * m10 + t1y * m11 + t1z * m12 + 0.3

    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, one)
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))
    radius = radius_f.to(torch.int32)

    opacity = opacities.reshape(n)
    # exact alpha >= 1/255 ellipse bbox (pixels outside have zero
    # contribution in the reference as well: its per-pixel alpha test skips
    # them), min'd with the reference's circular-radius rect
    t2 = 2.0 * torch.log(torch.clamp_min(opacity, 1e-12) * 255.0)
    t2 = torch.clamp_min(t2, 0.0)
    rx = torch.minimum(radius_f, torch.sqrt(t2 * torch.clamp_min(c00, 0.0)))
    ry = torch.minimum(radius_f, torch.sqrt(t2 * torch.clamp_min(c11, 0.0)))
    keep = in_front & det_ok & (t2 > 0.0)
    zero = torch.zeros((), dtype=rx.dtype, device=rx.device)
    rx = torch.where(keep, rx, zero)
    ry = torch.where(keep, ry, zero)

    # reference getRect semantics (half-open, clamped to grid)
    x0 = _tile_index((pix_x - rx) / TILE, tiles_x)
    y0 = _tile_index((pix_y - ry) / TILE, tiles_y)
    x1 = _tile_index((pix_x + rx + TILE - 1) / TILE, tiles_x)
    y1 = _tile_index((pix_y + ry + TILE - 1) / TILE, tiles_y)
    valid = keep & (x1 > x0) & (y1 > y0) & ((rx > 0.0) | (ry > 0.0))
    if alive is not None:
        valid = valid & alive
    rect = torch.stack([x0, y0, x1, y1], dim=-1) * valid[:, None].to(torch.int32)

    # reported radii/visibility keep the reference's semantics (its rect is
    # radius-circular and ignores opacity)
    rx0 = _tile_index((pix_x - radius_f) / TILE, tiles_x)
    ry0 = _tile_index((pix_y - radius_f) / TILE, tiles_y)
    rx1 = _tile_index((pix_x + radius_f + TILE - 1) / TILE, tiles_x)
    ry1 = _tile_index((pix_y + radius_f + TILE - 1) / TILE, tiles_y)
    valid_ref = in_front & det_ok & ((rx1 - rx0) * (ry1 - ry0) > 0)
    if alive is not None:
        valid_ref = valid_ref & alive
    radii = radius * valid_ref.to(torch.int32)

    # --- color ---
    if colors_precomp is not None:
        color = colors_precomp
    else:
        dirs = means3d - cam.campos[None, :]
        dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
        color = torch.clamp_min(sh_lib.eval_sh(sh_degree, shs, dirs) + 0.5, 0.0)

    return Preprocessed(xy, depth, conic, color, opacity, radii, rect, valid)


def default_cull_geo(prep: Preprocessed) -> torch.Tensor:
    """[N, 6] (cx, cy, A, B, C, t2): the 3DGS alpha>=1/255 screen ellipse.

    q(d) = A dx^2 + 2B dx dy + C dy^2 = -2*power <= t2 = 2 log(255 opa).
    """
    t2 = torch.clamp_min(
        2.0 * torch.log(torch.clamp_min(prep.opacity, 1e-12) * 255.0), 0.0
    )
    return torch.cat([prep.xy, prep.conic, t2[:, None]], dim=1)


def log2_opacity(opacity: torch.Tensor) -> torch.Tensor:
    """Stream column 9: log2(opacity), so the compositor evaluates alpha as
    one exp2(power + lopa). Clamped away from log2(0): a sub-1e-30 opacity
    yields alpha ~ 2^-99, dead at the 1/255 threshold either way."""
    return torch.log2(torch.clamp_min(opacity, 1e-30))


def conic_chol(conic: torch.Tensor) -> torch.Tensor:
    """[N, 3] scaled Cholesky factor (l11, l21, l22) of the conic
    [[A,B],[B,C]], in BASE-2 exponent units.

    A dx^2 + 2B dx dy + C dy^2 = (u^2 + v^2)/log2(e) with
    u = l11 dx + l21 dy and v = l22 dy: the sqrt(log2 e) scale is folded in
    here, so the compositor evaluates alpha as opa * exp2(-0.5 (u^2+v^2)),
    and the quadratic is non-negative by construction (the conic is PSD
    after the +0.3 low-pass dilation, so the factorization is exact).
    """
    a = torch.clamp_min(conic[:, 0], 1e-12)
    b = conic[:, 1]
    c = conic[:, 2]
    l11 = torch.sqrt(a)
    l21 = b / l11
    l22 = torch.sqrt(torch.clamp_min(c - l21 * l21, 1e-12))
    k2 = math.sqrt(math.log2(math.e))
    return k2 * torch.stack([l11, l21, l22], dim=1)


def depth_order(prep: Routable) -> torch.Tensor:
    """Stable depth sort, invalid gaussians last. Invalid gaussians have
    zeroed rects, so their tile counts are 0 and the valid ones form a
    contiguous prefix of the order."""
    with span("raster.route.depth_order"):
        inf = torch.full((), float("inf"), dtype=prep.depth.dtype, device=prep.depth.device)
        return torch.argsort(torch.where(prep.valid, prep.depth, inf), stable=True)


def key_routing(rect_sorted: torch.Tensor):
    """Per depth-sorted gaussian: (x0, y0, span, counts, starts, total) with
    `starts` the exclusive prefix sum of the rect tile counts (int64)."""
    r = rect_sorted.to(torch.int64)
    x0, y0, x1, y1 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    span = x1 - x0
    counts = span * (y1 - y0)
    starts = torch.cumsum(counts, 0) - counts
    total = starts[-1] + counts[-1]
    return x0, y0, span, counts, starts, total


def edge_min_q(dxlo, dxhi, dylo, dyhi, a, b, c):
    """Minimum of q(d) = A dx^2 + 2B dx dy + C dy^2 over the tile box
    [dxlo, dxhi] x [dylo, dyhi] (offsets from the ellipse center), by the
    exact minimum along each of the four edges. Returns (q_min, qabs, pd):
    qabs = |A|dx^2 + 2|B dx dy| + |C|dy^2 at the same point (the
    cancellation magnitude a tolerance can scale with) and pd whether the
    conic is positive definite. Zero when the center lies inside the box."""
    inside = (dxlo <= 0.0) & (0.0 <= dxhi) & (dylo <= 0.0) & (0.0 <= dyhi)
    sa = torch.clamp_min(a, 1e-12)
    sc = torch.clamp_min(c, 1e-12)

    def q_edge_x(e):
        dy = torch.minimum(torch.maximum(-b * e / sc, dylo), dyhi)
        cross = b * e * dy
        q = a * e * e + 2.0 * cross + c * dy * dy
        qa = sa * e * e + 2.0 * torch.abs(cross) + sc * dy * dy
        return q, qa

    def q_edge_y(f):
        dx = torch.minimum(torch.maximum(-b * f / sa, dxlo), dxhi)
        cross = b * f * dx
        q = c * f * f + 2.0 * cross + a * dx * dx
        qa = sc * f * f + 2.0 * torch.abs(cross) + sa * dx * dx
        return q, qa

    def min_pair(p1, p2):
        take1 = p1[0] <= p2[0]
        return torch.where(take1, p1[0], p2[0]), torch.where(take1, p1[1], p2[1])

    q_min, qabs = min_pair(
        min_pair(q_edge_x(dxlo), q_edge_x(dxhi)),
        min_pair(q_edge_y(dylo), q_edge_y(dyhi)),
    )
    zero = torch.zeros((), dtype=q_min.dtype, device=q_min.device)
    q_min = torch.where(inside, zero, q_min)
    qabs = torch.where(inside, zero, qabs)
    pd = (a > 0.0) & (c > 0.0) & (a * c - b * b > 0.0)
    return q_min, qabs, pd


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bf16 value (kept as f32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _expand_keys_core(
    prep: Preprocessed, width: int, height: int, k_cap: int, cull: bool = False,
):
    """The expansion golden. Returns (tile [K], g_of_k [K] position in
    depth-sorted order, order [N], total, ktx, kty, in_range, kept).

    cull=True applies the alpha>=1/255 ellipse vs 16x16-tile overlap test
    per key with the JAX golden's arithmetic: the center is quantized to
    1/32 px relative to the rect origin and the conic and threshold to bf16,
    and the keep test inflates the threshold by that quantization
    (1.02 t2 + 0.01 qabs + 0.9), so it never drops a key the f32 compositor
    would keep. A culled key has alpha < 1/255 at every pixel of its tile.
    """
    tiles_x, tiles_y = grid_dims(width, height)
    num_tiles = tiles_x * tiles_y
    n = prep.xy.shape[0]
    dev = prep.xy.device

    order = depth_order(prep)
    x0, y0, span, counts, starts, total = key_routing(prep.rect[order])

    ks = torch.arange(k_cap, dtype=torch.int64, device=dev)
    g_of_k = torch.searchsorted(starts, ks, right=True) - 1  # last g: starts[g] <= k
    g = g_of_k.clamp(0, n - 1)
    local = ks - starts[g]
    kx0, ky0 = x0[g], y0[g]
    kspan = span[g].clamp_min(1)
    ktx = kx0 + local % kspan
    kty = ky0 + local // kspan
    tile = kty * tiles_x + ktx
    in_range = (ks < torch.clamp_max(total, k_cap)) & (g_of_k >= 0)

    if cull:
        geo = default_cull_geo(prep)[order]
        gx_rel = geo[:, 0] - x0.to(torch.float32) * TILE
        gy_rel = geo[:, 1] - y0.to(torch.float32) * TILE
        gx_q = torch.clamp(torch.round(gx_rel * 32.0), 0, 65535) * (1.0 / 32.0)
        gy_q = torch.clamp(torch.round(gy_rel * 32.0), 0, 65535) * (1.0 / 32.0)
        # the 16-bit fixed point covers 2048 px of rect-relative center;
        # beyond it the clamp is not conservative: force-keep such keys
        overflow = (gx_rel > 2047.0) | (gy_rel > 2047.0)
        t2 = torch.where(overflow, torch.full_like(geo[:, 5], float("inf")), geo[:, 5])
        a, b, c, t2 = _bf16(geo[:, 2]), _bf16(geo[:, 3]), _bf16(geo[:, 4]), _bf16(t2)

        # tile pixel box relative to the rect origin (where centers live)
        fx = ((ktx - kx0) * TILE).to(torch.float32)
        fy = ((kty - ky0) * TILE).to(torch.float32)
        gx, gy = gx_q[g], gy_q[g]
        q_min, qabs, pd = edge_min_q(
            fx - gx, fx + (TILE - 1) - gx, fy - gy, fy + (TILE - 1) - gy,
            a[g], b[g], c[g],
        )
        t2k = t2[g]
        keep = ~pd | (q_min <= torch.abs(t2k) * 0.02 + t2k + 0.01 * qabs + 0.9)
        in_range = in_range & keep

    tile = torch.where(in_range, tile, torch.full_like(tile, num_tiles))
    kept = in_range.sum()
    return tile, g_of_k, order, total, ktx, kty, in_range, kept


def pack_bits(n: int) -> int:
    """Bits of the depth rank in the packed sort key
    (tile << bits) | depth_rank: depth ranks are unique, so one unstable sort
    keeps depth order within each tile."""
    return max(1, int(n - 1).bit_length())


def key_dtype(n: int, num_tiles: int) -> torch.dtype:
    """Width of the packed sort key, chosen from the shapes as the JAX
    package chooses it (`pallas_expand.packable`): int32 when
    (num_tiles + 1) << bits_g fits in a positive int32, else int64 (which
    fits every N)."""
    return torch.int32 if (num_tiles + 1) << pack_bits(n) <= (1 << 31) - 1 else torch.int64


def _tile_bounds(sorted_tile: torch.Tensor, num_tiles: int):
    """Per-tile (start, count) int32 ranges of a tile-sorted key array."""
    bounds = torch.searchsorted(
        sorted_tile,
        torch.arange(num_tiles + 1, dtype=sorted_tile.dtype, device=sorted_tile.device),
        out_int32=True,
    )
    return bounds[:-1].contiguous(), (bounds[1:] - bounds[:-1]).contiguous()


def sorted_expansion(prep: Routable, width: int, height: int, k_cap: int,
                     cull: bool = True, geo: torch.Tensor | None = None,
                     geo2: torch.Tensor | None = None):
    """Expansion (kernel K1 on CUDA tensors, its plain version on CPU) +
    one keys-only sort over the bits the keys use -> (sorted_tile [slots],
    g_sorted [slots], order, total, kept), in the keys' dtype (int32 or int64,
    `key_dtype`). Culled and out-of-range keys carry the sentinel tile
    `num_tiles` and sort past every live key. `geo`/`geo2` are the cull
    ellipses (default: the 3DGS ellipse alone)."""
    from .expand import expand_inputs, expand_keys
    from .sort import sort_keys

    x = expand_inputs(prep, width, height, k_cap, cull, geo, geo2)
    with span("raster.route.expand"):
        keys, kept = expand_keys(x)
    with span("raster.route.sort"):
        s = sort_keys(keys, x.end_bit)
    return s >> x.bits_g, s & ((1 << x.bits_g) - 1), x.order, x.total, kept


def stream_table(prep: Preprocessed) -> torch.Tensor:
    """[N, 10] per-gaussian stream rows, in gaussian order, which K2 and K3
    read gathered by the routing's `gid` (grouped by tile, depth-ascending).
    Columns: 0-1 xy, 2-4 conic Cholesky factor × sqrt(log2 e) (conic_chol),
    5-7 color, 8 depth, 9 log2(opacity) (log2_opacity)."""
    return torch.cat(
        [
            prep.xy,
            conic_chol(prep.conic),
            prep.color,
            prep.depth[:, None],
            log2_opacity(prep.opacity)[:, None],
        ],
        dim=1,
    )


def route_stream(prep: Routable, width: int, height: int, cfg: RasterConfig,
                 geo: torch.Tensor | None = None,
                 geo2: torch.Tensor | None = None) -> StreamRouting:
    """Expansion + sort -> the gaussian row of every stream slot and the
    per-tile ranges. Integer work only: the training path runs it under
    no_grad on the detached prep, as the JAX package stops gradients at its
    routing (`pallas.py:324`). `prep` is either rasterizer's preprocess
    output (`Routable` says what is read of it). `geo`/`geo2` are K1's cull
    ellipses (default: the 3DGS ellipse; the surfel path passes its conic
    and circle).

    The stream has min(K2, slots) slots, `slots` the length of K1's key
    buffer (`expand.key_slots`); `route_stream.slots` and
    `route_stream.capacity` add up the slots and the capacities of every
    call, so their ratio is the share of the capacity the sizing spends."""
    tiles_x, tiles_y = grid_dims(width, height)
    num_tiles = tiles_x * tiles_y
    k_cap = cfg.max_keys
    k2 = min(cfg.stream_cap, k_cap)

    with span("raster.route"):
        sorted_tile, g_sorted, order, total, kept = sorted_expansion(
            prep, width, height, k_cap, cull=True, geo=geo, geo2=geo2
        )
        slots = sorted_tile.shape[0]
        # culled + out-of-range keys sort past every live key, so slicing to
        # the post-cull capacity is the compaction; their slots get a valid but
        # meaningless row that no tile range reaches
        gid = order[g_sorted[:k2]].to(torch.int32)
        tile_start, tile_count = _tile_bounds(sorted_tile[:k2], num_tiles)
        dropped = torch.clamp_min(total - k_cap, 0) + torch.clamp_min(kept - k2, 0)
    route_stream.slots += slots
    route_stream.capacity += k_cap
    return StreamRouting(gid, tile_start, tile_count, dropped)


route_stream.slots = 0
route_stream.capacity = 0


def tiles_cp_to_image(tile_img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[num_tiles, C, TILE*TILE] -> [C, H, W] (crop the tile-grid padding)."""
    tiles_x, tiles_y = grid_dims(width, height)
    c = tile_img.shape[1]
    img = tile_img.reshape(tiles_y, tiles_x, c, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, tiles_y * TILE, tiles_x * TILE)
    return img[:, :height, :width]


def expected_depth(depth_accum: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The alpha-normalised depth map: depth_accum / alpha, with alpha taken
    as 1 where it is 0, and NaN and ±inf set to 0."""
    one = torch.ones((), dtype=alpha.dtype, device=alpha.device)
    depth = depth_accum / torch.where(alpha == 0.0, one, alpha)
    return torch.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
