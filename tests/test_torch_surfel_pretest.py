"""The surfel kernels' two skips are sound. The division-free pre-test
(`csrc/surfel_common.cuh:may_hit`, mirrored by
`surfel_composite.py:surfel_pretest`) rejects no (pixel, key) pair whose
exact `surfel_hit` alpha reaches 1/255, and the per-warp mask
(`warp_mask`, mirrored by `surfel_warp_mask`) is clear only for a warp in
none of whose pixels the pre-test passes. K4, K5 and K6 skip a key for a
warp on either, so a wrong rejection would silently drop a contribution.
Checked on random surfel streams, edge-on surfels (s_z at its 1e-9 clamp),
pairs whose |u| is clipped at 1e3, log2 opacities near -log2 255 and pairs
built to land within a few ulps of alpha = 1/255; and both reject a share
of the dead pairs and slots of a random scene, which is what they are for."""

import importlib

import numpy as np
import pytest
import torch

from scorp_tpu_torch.ops.raster.composite import pixel_coords
from scorp_tpu_torch.ops.raster.surfel import ALPHA_MIN, SURFEL_COLS
from scorp_tpu_torch.ops.raster.surfel_composite import (
    surfel_hit,
    surfel_pretest,
    surfel_warp_mask,
)
from tests.test_torch_surfel import TILES_X, _stream, scene

LOG2_255 = np.log2(255.0)
# the module (ops.raster re-exports a function of the same name)
surfel_composite_module = importlib.import_module("scorp_tpu_torch.ops.raster.surfel_composite")


def _stream_pairs(arrays):
    """alpha, the pre-test and the warp mask bit of every (pixel, key) pair
    of the stream `arrays` routes, over each tile's keys: [T, C, 256] each,
    and the valid keys [T, C]."""
    table, route = _stream(arrays)
    data = table.detach()[route.gid.long()]
    count = route.tile_count.long()
    n_tiles = count.shape[0]
    j = torch.arange(int(count.max()))
    valid = j[None, :] < count[:, None]                                   # [T, C]
    idx = (route.tile_start.long()[:, None] + j[None, :]).clamp_max(data.shape[0] - 1)
    px, py = pixel_coords(n_tiles, TILES_X, torch.float32, torch.device("cpu"))
    rows = data[idx]
    t = torch.arange(n_tiles)
    mask = surfel_warp_mask(rows, (t % TILES_X) * 16, (t // TILES_X) * 16)
    return (surfel_hit(rows, px, py)["alpha"], surfel_pretest(rows, px, py),
            mask.repeat_interleave(32, dim=-1), valid)


def _assert_sound(alpha, pre, mask):
    live = alpha >= ALPHA_MIN
    assert int(live.sum()) > 0
    assert not bool((live & ~pre).any()), f"{int((live & ~pre).sum())} live pairs rejected"
    assert not bool((pre & ~mask).any()), f"{int((pre & ~mask).sum())} pairs masked off"


def _rows(n):
    return np.zeros((n, SURFEL_COLS), np.float32)


def _hit_and_pretest(rows, px, py):
    """surfel_hit's alpha, the pre-test and the warp mask bit of key i at
    integer pixel i: [n] each."""
    px, py = np.asarray(px, np.float32), np.asarray(py, np.float32)
    r = torch.as_tensor(rows)[:, None, :]                                 # [n, 1, 21]
    x = torch.as_tensor(px)[:, None]                                      # [n, 1]
    y = torch.as_tensor(py)[:, None]
    x0, y0 = torch.as_tensor(px // 16 * 16), torch.as_tensor(py // 16 * 16)
    warp = torch.as_tensor(((py - py // 16 * 16) // 2).astype(np.int64))
    mask = surfel_warp_mask(r, x0, y0)[:, 0].gather(1, warp[:, None])[:, 0]
    return surfel_hit(r, x, y)["alpha"][:, 0, 0], surfel_pretest(r, x, y)[:, 0, 0], mask


@pytest.mark.parametrize("n,seed", [(60, 13), (200, 5), (400, 21)])
def test_skips_keep_every_live_pair_of_random_streams(n, seed):
    alpha, pre, mask, valid = _stream_pairs(scene(n=n, seed=seed))
    keep = valid[..., None].expand_as(alpha)
    _assert_sound(alpha[keep], pre[keep], mask[keep])
    # and they are worth running: the pre-test rejects most dead pairs, the
    # mask most of the (warp, key) slots in which no lane passes it
    dead = (alpha < ALPHA_MIN)[keep]
    assert float((dead & ~pre[keep]).sum()) / int(dead.sum()) > 0.2
    warp_pre = pre.view(*pre.shape[:2], 8, 32).any(-1)[valid]
    warp_mask = mask.view(*mask.shape[:2], 8, 32)[..., 0][valid]
    assert float((~warp_pre & ~warp_mask).sum()) / int((~warp_pre).sum()) > 0.2


def test_skips_on_edge_on_surfels():
    """The normal in the image plane: s_z = 0 at the clamp (sz = 1e-9) or
    within a few ulps of it, and |u| huge or clipped."""
    rng = np.random.default_rng(4)
    arrays = scene(n=80, seed=3)
    # rotate the z axis onto x: the camera on the z axis sees discs edge-on
    q = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0], np.float32)
    arrays[2] = np.tile(q, (80, 1)) + rng.normal(0, 1e-4, (80, 4)).astype(np.float32)
    alpha, pre, mask, valid = _stream_pairs(arrays)
    keep = valid[..., None].expand_as(alpha)
    _assert_sound(alpha[keep], pre[keep], mask[keep])

    n = 20000
    rows = _rows(n)
    px = rng.integers(0, 64, n)
    py = rng.integers(0, 64, n)
    rows[:, 0:3] = rng.normal(0, 1e-6, (n, 3))
    rows[:, 3:6] = rng.normal(0, 1e-6, (n, 3))
    rows[:, 6:9] = rng.normal(0, 1e-9, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.5)
    rows[:, 12] = px + rng.normal(0, 1.5, n)
    rows[:, 13] = py + rng.normal(0, 1.5, n)
    rows[:, 11] = 1.0
    rows[:, 20] = np.log2(rng.uniform(0.01, 1.0, n))
    _assert_sound(*_hit_and_pretest(rows, px, py))


def test_skips_with_clipped_u():
    """|u_raw| > 1e3: the 3D branch is dead (rho3d >= 1e6), only the
    low-pass distance can keep a pair alive."""
    rng = np.random.default_rng(8)
    n = 20000
    rows = _rows(n)
    px = rng.integers(0, 64, n)
    py = rng.integers(0, 64, n)
    rows[:, 2] = rng.choice([-1.0, 1.0], n) * rng.uniform(1.0001e3, 1e8, n)
    rows[:, 5] = rng.normal(0, 10, n)
    rows[:, 8] = 1.0
    rows[:, 12] = px + rng.normal(0, 2.0, n)
    rows[:, 13] = py + rng.normal(0, 2.0, n)
    rows[:, 11] = 1.0
    rows[:, 20] = np.log2(rng.uniform(0.005, 1.0, n))
    alpha, pre, mask = _hit_and_pretest(rows, px, py)
    _assert_sound(alpha, pre, mask)
    assert int((alpha < ALPHA_MIN).sum()) > 0 and not bool(pre.all())


@pytest.mark.parametrize("branch", ["3d", "2d"])
def test_skips_at_the_alpha_threshold(branch, monkeypatch):
    """Pairs within a few ulps of alpha = 1/255, for log2 opacities from
    just above -log2 255 up to 0: rho is placed on the threshold
    2 ln2 (lopa + log2 255) scaled by (1 + k 2^-24), k in [-64, 64], at
    pixels across the image, through either rho3d or rho2d. The rounding of
    exp2 and of the divisions needs a margin in rho on these pairs (without
    one some live pairs are rejected, checked at the end); the kernels take
    1e-3."""
    rng = np.random.default_rng(1 if branch == "3d" else 2)
    lopa = np.concatenate([-LOG2_255 + np.geomspace(1e-6, 1e-2, 40),
                           rng.uniform(-LOG2_255, 0.0, 200), [0.0]]).astype(np.float32)
    k = np.arange(-64, 65)
    lopa_k = np.repeat(lopa, k.size)
    scale = np.tile(1.0 + k * 2.0 ** -24, lopa.size)
    n = lopa_k.size
    r_thr = 2.0 * np.log(2.0) * (lopa_k.astype(np.float64) + LOG2_255)
    dist = np.sqrt(np.maximum(r_thr, 0.0)) * scale                      # target sqrt(rho)
    px = rng.integers(0, 1600, n).astype(np.float32)
    py = rng.integers(0, 1066, n).astype(np.float32)
    rows = _rows(n)
    rows[:, 20] = lopa_k
    rows[:, 11] = 1.0
    theta = rng.uniform(0, 2 * np.pi, n)
    if branch == "3d":
        # s = adj (px, py, 1) with sz = a3 . (px, py, 1) of either sign and
        # (sx, sy) = dist (cos, sin) sz; the low-pass centre far away
        sz = rng.choice([-1.0, 1.0], n) * rng.uniform(0.5, 4.0, n)
        rows[:, 6] = rng.normal(0, 1e-3, n)
        rows[:, 7] = rng.normal(0, 1e-3, n)
        a3 = rows[:, 6:9].astype(np.float64)
        rows[:, 8] = sz - a3[:, 0] * px - a3[:, 1] * py
        a3 = rows[:, 6:9].astype(np.float64)
        sz = a3[:, 0] * px + a3[:, 1] * py + a3[:, 2]
        rows[:, 2] = dist * np.cos(theta) * sz
        rows[:, 5] = dist * np.sin(theta) * sz
        rows[:, 12] = px + 1e3
        rows[:, 13] = py
    else:
        # u clipped away, rho2d = 2 |c - p|^2 on the threshold (pixels near
        # the origin, so that the centre's rounding stays below an ulp of rho)
        px, py = px % 16, py % 16
        rows[:, 2] = 1e6
        rows[:, 8] = 1.0
        rows[:, 12] = px + dist / np.sqrt(2.0) * np.cos(theta)
        rows[:, 13] = py + dist / np.sqrt(2.0) * np.sin(theta)
    alpha, pre, mask = _hit_and_pretest(rows, px, py)
    _assert_sound(alpha, pre, mask)
    # the pairs straddle the threshold: some on each side, within a few ulps
    live = alpha >= ALPHA_MIN
    assert 0 < int(live.sum()) < n
    near = (alpha - ALPHA_MIN).abs() <= 8 * np.spacing(np.float32(ALPHA_MIN))
    assert int((near & live).sum()) > 100 and int((near & ~live).sum()) > 100
    # close enough that the margin matters: without it, live pairs would go
    monkeypatch.setattr(surfel_composite_module, "PRETEST_MARGIN", 0.0)
    assert bool((live & ~_hit_and_pretest(rows, px, py)[1]).any())


def test_warp_mask_at_the_rectangle_edges():
    """Discs whose footprint ends within rounding of a warp's two pixel
    rows or its 16 columns, at full-width pixel coordinates, tilted so that
    s_z varies: the mask keeps every warp in which the pre-test passes."""
    rng = np.random.default_rng(6)
    n = 40000
    x0 = rng.integers(0, 100, n) * 16.0
    y0 = rng.integers(0, 66, n) * 16.0
    w = rng.integers(0, 8, n)
    lopa = rng.uniform(-LOG2_255, 0.0, n)
    reach = np.sqrt(2.0 * np.log(2.0) * (lopa + LOG2_255))               # sqrt(r) on the threshold
    # a disc of radius a * reach pixels centred just outside one edge of
    # the warp's rectangle, its edge at the rectangle's border +- an ulp
    a = np.exp(rng.uniform(np.log(0.3), np.log(20.0), n))
    side = rng.integers(0, 4, n)
    gap = a * reach * (1.0 + rng.integers(-8, 9, n) * 2.0 ** -22)
    cx = np.where(side == 0, x0 - gap, np.where(side == 1, x0 + 15 + gap, x0 + rng.uniform(0, 15, n)))
    cy = np.where(side == 2, y0 + 2 * w - gap,
                  np.where(side == 3, y0 + 2 * w + 1 + gap, y0 + 2 * w + rng.uniform(0, 1, n)))
    t1, t2 = rng.normal(0, 1e-4, n), rng.normal(0, 1e-4, n)
    rows = _rows(n)
    rows[:, 0:3] = np.stack([1 / a, 0 * a, -cx / a], 1)
    rows[:, 3:6] = np.stack([0 * a, 1 / a, -cy / a], 1)
    rows[:, 6:9] = np.stack([t1, t2, 1.0 - t1 * cx - t2 * cy], 1)
    rows[:, 12], rows[:, 13] = cx, cy
    rows[:, 11] = 1.0
    rows[:, 20] = lopa
    # every pixel of the chosen warp
    pix = np.arange(32)
    px = (x0[:, None] + pix % 16).ravel()
    py = (y0[:, None] + 2 * w[:, None] + pix // 16).ravel()
    alpha, pre, mask = _hit_and_pretest(np.repeat(rows, 32, axis=0), px, py)
    _assert_sound(alpha, pre, mask)
    warp_pre = pre.view(n, 32).any(1)
    warp_mask = mask.view(n, 32)[:, 0]
    assert 0 < int(warp_pre.sum()) < n and int((~warp_mask).sum()) > 0
