"""The 3DGS compositors' per-warp skip is sound. The warp mask
(`csrc/gauss_common.cuh:warp_mask`, mirrored by
`composite.py:gauss_warp_mask`) is clear only for a warp in none of whose 32
pixels the exact alpha (`gauss_alpha`, the kernels' expression) reaches
1/255. K2 and K3 skip a key for a warp whose bit is clear, so a wrong
rejection would silently drop a contribution. Checked on random streams of
the 3DGS test scenes, log2 opacities within ulps of -log2 255, pairs built
on the 1/255 threshold at a warp's edge, near-degenerate conics, centres on
warp and tile edges and non-finite rows; the mask also skips a share of the
dead slots of a random scene, which is what it is for. Last, a simulation
of K3's slot walk (each warp up to its own largest n_contrib, the mask, the
reciprocal, the folded columns and the per-block sums) gives the plain
version's d_table."""

import numpy as np
import pytest
import torch

from scorp_tpu_torch.ops.raster import common as tc
from scorp_tpu_torch.ops.raster.backward import LN2, composite_backward_plain
from scorp_tpu_torch.ops.raster.common import ALPHA_MIN, DATA_ROWS, RasterConfig
from scorp_tpu_torch.ops.raster.composite import (
    composite_plain,
    gauss_alpha,
    gauss_warp_mask,
    pixel_coords,
)
from tests.test_pallas import make_saturating_scene
from tests.test_raster import CAM, make_scene
from tests.test_torch_raster import port_camera, t

torch.set_num_threads(1)

W, H = CAM.width, CAM.height
TILES_X = tc.grid_dims(W, H)[0]
LOG2_255 = np.log2(255.0)
SCENES = {
    "random": lambda: make_scene(n=300, seed=3),
    "large": lambda: make_scene(n=120, seed=8, scale=0.2),
    "tiny": lambda: make_scene(n=400, seed=4, scale=0.01, opacity_logit=-1.0),
    "saturating": lambda: make_saturating_scene(n=200, seed=11),
}


def _route(scene):
    xyz, scales, quats, opa, shs = SCENES[scene]()
    prep = tc.preprocess_plain(t(xyz), t(opa), port_camera(), shs=t(shs), sh_degree=0,
                         scales=t(scales), quats=t(quats))
    return tc.stream_table(prep), tc.route_stream(prep, W, H, RasterConfig(max_keys=1 << 14))


def _tile_rows(data, start, count):
    """Every tile's keys: rows [T, C, 10], valid [T, C], the key index."""
    c = count.long()
    j = torch.arange(int(c.max()))
    idx = (start.long()[:, None] + j[None, :]).clamp_max(data.shape[0] - 1)
    return data[idx], j[None, :] < c[:, None], j, idx


def _origins(n_tiles, tiles_x=TILES_X):
    tile = torch.arange(n_tiles)
    return (tile % tiles_x) * 16, (tile // tiles_x) * 16


def _assert_sound(alpha, mask):
    """alpha [..., 8, 32] per warp pixel, mask [..., 8]: no warp with a live
    pixel is masked off."""
    live = (alpha >= ALPHA_MIN).any(-1)
    lost = live & ~mask
    assert not bool(lost.any()), f"{int(lost.sum())} live (warp, key) slots masked off"
    return live


@pytest.mark.parametrize("scene", list(SCENES))
def test_mask_keeps_every_live_slot_of_random_streams(scene):
    table, route = _route(scene)
    rows, valid, _, _ = _tile_rows(table.detach()[route.gid.long()], route.tile_start,
                                   route.tile_count)
    n_tiles = valid.shape[0]
    px, py = pixel_coords(n_tiles, TILES_X, torch.float32, torch.device("cpu"))
    alpha = gauss_alpha(rows, px, py)["alpha"].view(n_tiles, -1, 8, 32)[valid]
    mask = gauss_warp_mask(rows, *_origins(n_tiles))[valid]
    live = _assert_sound(alpha, mask)
    assert int(live.sum()) > 0
    # and it is worth running: it skips a share of the dead slots (the
    # saturating scene's splats cover every warp of their tiles)
    if scene in ("random", "tiny"):
        assert float((~live & ~mask).sum()) / int((~live).sum()) > 0.2


def _warp_alpha(rows, x0, y0, w):
    """Alpha of key i at the 32 pixels of warp w[i] of the tile at
    (x0[i], y0[i]) and the key's mask bit for that warp: [n, 32], [n]."""
    n = rows.shape[0]
    pix = np.arange(32)
    px = torch.as_tensor((x0[:, None] + pix % 16).astype(np.float32))
    py = torch.as_tensor((y0[:, None] + 2 * w[:, None] + pix // 16).astype(np.float32))
    r = torch.as_tensor(rows)[:, None, :]                                  # [n, 1, 10]
    alpha = gauss_alpha(r, px, py)["alpha"][:, 0]                          # [n, 32]
    mask = gauss_warp_mask(r, torch.as_tensor(x0).long(), torch.as_tensor(y0).long())[:, 0]
    return alpha, mask.gather(1, torch.as_tensor(w)[:, None])[:, 0]


def _rows(x, y, l11, l21, l22, lopa):
    rows = np.zeros((np.size(x), DATA_ROWS), np.float32)
    rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4] = x, y, l11, l21, l22
    rows[:, 5:8], rows[:, 8], rows[:, 9] = 0.5, 2.0, lopa
    return rows


def _random_warps(rng, n):
    return (rng.integers(0, 100, n) * 16.0, rng.integers(0, 66, n) * 16.0,
            rng.integers(0, 8, n))


def test_mask_with_opacity_near_the_threshold():
    """lopa = -log2 255 + k ulps, k in [-64, 64]: the key reaches 1/255
    only at its centre, placed on a warp pixel, beside it or far away."""
    rng = np.random.default_rng(2)
    k = np.repeat(np.arange(-64, 65), 40)
    n = k.size
    lopa = (np.float32(-LOG2_255) + k * np.spacing(np.float32(LOG2_255))).astype(np.float32)
    x0, y0, w = _random_warps(rng, n)
    off = rng.choice([0.0, 0.0, 0.5, 1.0, 3.0], n) * rng.choice([-1.0, 1.0], n)
    cx = x0 + rng.integers(0, 16, n) + off
    cy = y0 + 2 * w + rng.integers(0, 2, n) + rng.choice([0.0, 0.25, -1.0], n)
    rows = _rows(cx, cy, rng.uniform(0.2, 2.0, n), rng.normal(0, 0.3, n),
                 rng.uniform(0.2, 2.0, n), lopa)
    alpha, mask = _warp_alpha(rows, x0, y0, w)
    live = _assert_sound(alpha[:, None], mask[:, None])
    assert 0 < int(live.sum()) < n and int((~mask).sum()) > 0


@pytest.mark.parametrize("side", ["left", "right", "top", "bottom"])
def test_mask_on_the_threshold_at_a_warp_edge(side):
    """Ellipses whose footprint ends within a few ulps of alpha = 1/255 at a
    pixel on one edge of a warp's rectangle, at full-width coordinates: the
    centre lies outside the edge on the pixel's row or column, so that pixel
    is the warp's nearest; then the log2 opacity is set so that the f32
    exponent power + lopa there is -log2 255 + k 2^-25, k in [-64, 64]. The
    conic is axis-aligned or slightly sheared."""
    rng = np.random.default_rng(["left", "right", "top", "bottom"].index(side))
    k = np.tile(np.arange(-64, 65), 40)
    n = k.size
    thr = 2.0 * (rng.uniform(-LOG2_255 + 1e-3, 0.0, n) + LOG2_255)
    x0, y0, w = _random_warps(rng, n)
    l11 = np.exp(rng.uniform(np.log(0.1), np.log(3.0), n))
    l22 = np.exp(rng.uniform(np.log(0.1), np.log(3.0), n))
    l21 = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.normal(0, 1e-3, n))
    if side in ("left", "right"):
        # on the pixel's row: v = 0, u = l11 dx
        py = y0 + 2 * w + rng.integers(0, 2, n)
        px = x0 + (0 if side == "left" else 15)
        gap = np.sqrt(thr) / l11
        cx, cy = np.where(side == "left", px - gap, px + gap), py
    else:
        # on the pixel's column: u = l21 dy, v = l22 dy
        px = x0 + rng.integers(0, 16, n)
        py = y0 + 2 * w + (0 if side == "top" else 1)
        gap = np.sqrt(thr / (l21 ** 2 + l22 ** 2))
        cx, cy = px, np.where(side == "top", py - gap, py + gap)
    rows = _rows(cx, cy, l11, l21, l22, 0.0)
    a = gauss_alpha(torch.as_tensor(rows)[:, None, :], torch.as_tensor(px + 0.0 * cx)[:, None]
                    .float(), torch.as_tensor(py + 0.0 * cy)[:, None].float())
    power = (-0.5 * (a["u"] * a["u"] + a["v"] * a["v"]))[:, 0, 0].double().numpy()
    rows[:, 9] = -LOG2_255 - power + k * 2.0 ** -25
    alpha, mask = _warp_alpha(rows, x0, y0, w)
    live = _assert_sound(alpha[:, None], mask[:, None])
    # the pairs straddle the threshold, within a few ulps
    best = alpha.max(dim=1).values
    near = (best - ALPHA_MIN).abs() <= 8 * np.spacing(np.float32(ALPHA_MIN))
    assert int((near & live[:, 0]).sum()) > 100 and int((near & ~live[:, 0]).sum()) > 100
    # and the mask is tight: 0.01 less lopa (0.02 more in u² + v² than the
    # radius allows, above its 1e-3 margin) clears nearly every bit
    rows[:, 9] -= 0.01
    assert float((~_warp_alpha(rows, x0, y0, w)[1]).float().mean()) > 0.95


def test_mask_with_near_degenerate_conics():
    """l22 down to 1e-9 (a needle along y), l11 up to 1e5 (a blade along x),
    sheared: centres within a few pixels of the warp or on its edges."""
    rng = np.random.default_rng(7)
    n = 30000
    x0, y0, w = _random_warps(rng, n)
    l11 = np.exp(rng.uniform(np.log(1e-3), np.log(1e5), n))
    l22 = np.exp(rng.uniform(np.log(1e-9), np.log(1e-1), n))
    l21 = rng.normal(0, 1, n) * np.exp(rng.uniform(np.log(1e-6), np.log(1e2), n))
    edge = rng.uniform(size=n) < 0.5
    cx = np.where(edge, x0 + rng.choice([0.0, 15.0], n), x0 + rng.uniform(-8, 24, n))
    cy = y0 + 2 * w + np.where(edge, rng.choice([0.0, 1.0], n), rng.uniform(-40, 40, n))
    lopa = np.log2(rng.uniform(0.004, 1.0, n))
    alpha, mask = _warp_alpha(_rows(cx, cy, l11, l21, l22, lopa), x0, y0, w)
    live = _assert_sound(alpha[:, None], mask[:, None])
    assert 0 < int(live.sum()) < n and int((~mask).sum()) > 1000


def test_mask_with_centres_on_tile_edges():
    """Centres on the tile's and the warps' pixel rows and columns and
    half-way between tiles, every warp of the tile checked."""
    rng = np.random.default_rng(9)
    n = 4000
    x0, y0, _ = _random_warps(rng, n)
    cx = x0 + rng.choice([-0.5, 0.0, 7.5, 15.0, 15.5, 16.0], n)
    cy = y0 + rng.choice([-0.5, 0.0, 1.0, 2.0, 7.0, 7.5, 8.0, 15.0, 15.5, 16.0], n)
    rows = _rows(cx, cy, rng.uniform(0.05, 1.5, n), rng.normal(0, 0.3, n),
                 rng.uniform(0.05, 1.5, n), np.log2(rng.uniform(0.004, 1.0, n)))
    for w in range(8):
        alpha, mask = _warp_alpha(rows, x0, y0, np.full(n, w))
        _assert_sound(alpha[:, None], mask[:, None])
        assert 0 < int(mask.sum()) < n


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, 3e18])
def test_mask_sets_every_bit_for_non_finite_rows(value):
    rng = np.random.default_rng(5)
    for c in (0, 1, 2, 3, 4, 9):
        rows = _rows(np.array([1000.0]), np.array([1000.0]), 0.5, 0.1, 0.5, -1.0)
        rows[0, c] = value
        if c == 9 and value < 0:
            continue  # lopa = -inf is a key of opacity 0, dead everywhere
        x0, y0 = torch.as_tensor(rng.integers(0, 100, 1) * 16), torch.as_tensor([16])
        mask = gauss_warp_mask(torch.as_tensor(rows)[:, None, :], x0, y0)
        assert bool(mask.all()), (c, value)


def _simulate_k3(data, gid, start, count, bg, g_color, g_depth, g_alpha, t_final,
                 n_contrib, n_rows, tiles_x):
    """K3's walk, vectorised over tiles: per key position from the top down,
    a warp takes the key only below its largest n_contrib and where its mask
    bit is set; emitting lanes take the reciprocal form and the folded
    columns, the warps' sums meet per (tile, key) and each row gets the
    flush's factors. Returns d_table and the emitting pairs [T, C, 256]."""
    rows, valid, j, idx = _tile_rows(data, start, count)
    n_tiles = valid.shape[0]
    px, py = pixel_coords(n_tiles, tiles_x, torch.float32, data.device)
    nc = n_contrib[:, 0].long()
    warp_mx = nc.view(n_tiles, 8, 32).amax(-1)                             # [T, 8]
    walked = valid[..., None] & (j[None, :, None] < warp_mx[:, None, :])   # [T, C, 8]
    slot = walked & gauss_warp_mask(rows, *_origins(n_tiles, tiles_x))
    a = gauss_alpha(rows, px, py)
    emit = (slot.repeat_interleave(32, -1) & (j[None, :, None] < nc[:, None, :])
            & (a["alpha"] >= ALPHA_MIN))
    gc, gd = g_color, g_depth[:, 0]
    gt_term = t_final[:, 0] * (bg[0] * gc[:, 0] + bg[1] * gc[:, 1] + bg[2] * gc[:, 2]
                               - g_alpha[:, 0])
    trans, suffix = t_final[:, 0].clone(), torch.zeros_like(gd)
    cols = torch.zeros(n_tiles, j.shape[0], DATA_ROWS, 256)
    for i in reversed(range(j.shape[0])):
        e, al, r = emit[:, i], a["alpha"][:, i], rows[:, i, :, None]
        inv_om = 1.0 / (1.0 - al)
        t_before = trans * inv_om
        w = al * t_before
        cu = r[:, 5] * gc[:, 0] + r[:, 6] * gc[:, 1] + r[:, 7] * gc[:, 2] + r[:, 8] * gd
        dpow = a["alpha_u"][:, i] * (t_before * cu - (suffix + gt_term) * inv_om)
        ud, vd = a["u"][:, i] * dpow, a["v"][:, i] * dpow
        col = torch.stack([r[:, 2] * ud, r[:, 3] * ud + r[:, 4] * vd, ud * a["dx"][:, i],
                           ud * a["dy"][:, i], vd * a["dy"][:, i], w * gc[:, 0], w * gc[:, 1],
                           w * gc[:, 2], w * gd, dpow], 1)
        cols[:, i] = torch.where(e[:, None], col, 0.0)
        suffix = torch.where(e, suffix + w * cu, suffix)
        trans = torch.where(e, t_before, trans)
    acc = cols.view(n_tiles, j.shape[0], DATA_ROWS, 8, 32).sum(-1).sum(-1)  # [T, C, 10]
    factor = torch.tensor([-LN2] * 5 + [1.0] * 4 + [LN2])
    d_table = torch.zeros(n_rows, DATA_ROWS)
    d_table.index_add_(0, gid[idx[valid]].long(), (acc * factor)[valid])
    return d_table, emit, walked


@pytest.mark.parametrize("scene", ["random", "saturating"])
def test_k3_slot_walk_gives_the_plain_gradient(scene):
    table, route = _route(scene)
    data = table.detach()[route.gid.long()].contiguous()
    bg = torch.tensor([0.2, 0.3, 0.4])
    _, _, _, n_contrib, t_final = composite_plain(
        data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X, track_ncontrib=True,
        with_t_final=True)
    rng = np.random.default_rng(1)
    g = [torch.as_tensor(rng.normal(size=(route.tile_start.shape[0], c, 256)),
                         dtype=torch.float32) for c in (3, 1, 1)]
    args = (data, route.gid, route.tile_start, route.tile_count, bg, *g, t_final, n_contrib,
            table.shape[0])
    ref = composite_backward_plain(*args, tiles_x=TILES_X)
    got, emit, walked = _simulate_k3(*args, TILES_X)
    # the same pairs emit as in the plain walk: j < n_contrib, alpha >= 1/255
    rows, valid, j, _ = _tile_rows(data, route.tile_start, route.tile_count)
    px, py = pixel_coords(valid.shape[0], TILES_X, torch.float32, torch.device("cpu"))
    plain_emit = (valid[..., None] & (j[None, :, None] < n_contrib[:, 0].long()[:, None, :])
                  & (gauss_alpha(rows, px, py)["alpha"] >= ALPHA_MIN))
    assert torch.equal(emit, plain_emit)
    if scene == "random":  # the walk skipped slots (every warp emits in the other)
        assert int(walked.sum()) > int(emit.view(*emit.shape[:2], 8, 32).any(-1).sum())
    scale = ref.abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert bool(((got - ref).abs() <= 1e-5 * scale).all())
