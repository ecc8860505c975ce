"""Port parity, the routing (K1's packed keys and their sort): the key width
the port picks against scorp_tpu's `packable` rule; the int32 route against
an int64 reference built from the same plain keys, and the route sized by
the frame's keys against the full-capacity decode; one route past the
int32 edge (262,145 rows at 1600x1066); the key buffer's length rule
(`key_slots`) on its own and through the route, at bucket edges, with
nothing on screen and past the capacity; and the PyTorch mirror of K1's
per-block search (`block_search_plain`) against `searchsorted`, on the test
scenes and on hand-made prefix sums. All on the CPU."""

import numpy as np
import pytest
import torch

from scorp_tpu.ops.raster.pallas_expand import packable
from scorp_tpu_torch.core.camera import look_at_camera
from scorp_tpu_torch.ops.raster import RasterConfig, preprocess_plain
from scorp_tpu_torch.ops.raster import common as tc
from scorp_tpu_torch.ops.raster import surfel as ts
from scorp_tpu_torch.ops.raster.expand import (
    BLOCK_SLOTS,
    SLOT_BUCKET,
    block_search_plain,
    expand_inputs,
    expand_keys,
    expand_keys_plain,
    key_slots,
    warp_search_plain,
)
from scorp_tpu_torch.ops.raster.sort import sort_keys
from tests.test_raster import make_scene
from tests.test_torch_raster import H, W, both_preps, port_camera, t
from tests.test_torch_surfel import scene as surfel_scene

torch.set_num_threads(1)


# --- (a) the width rule ------------------------------------------------------

def test_key_dtype_matches_jax_packable_on_a_grid():
    ns = [1, 2, 3, 200, 4097, 65536, 65537, 262_144, 262_145, 1 << 20, (1 << 24) + 1]
    tiles = [1, 2, 100, 1900, 6700, 8191, 8192, 16383, 1 << 20]
    for n in ns:
        for num_tiles in tiles:
            ok, bits_g = packable(n, num_tiles)
            assert tc.pack_bits(n) == bits_g
            want = torch.int32 if ok else torch.int64
            assert tc.key_dtype(n, num_tiles) == want, (n, num_tiles)


@pytest.mark.parametrize("bits_g", [1, 10, 18, 19, 24, 30])
def test_key_dtype_on_both_sides_of_the_int32_edge(bits_g):
    n = 1 << bits_g  # pack_bits(n) == bits_g
    edge = ((1 << 31) - 1 >> bits_g) - 1  # the most tiles whose keys fit in int32
    for num_tiles, ok in [(edge, True), (edge + 1, False)]:
        if num_tiles < 1:
            continue
        assert packable(n, num_tiles) == (ok, bits_g)
        assert tc.key_dtype(n, num_tiles) == (torch.int32 if ok else torch.int64)
        if ok:  # the sentinel, the largest key, is a positive int32
            assert num_tiles << bits_g < (1 << 31) - 1


def test_key_dtype_at_the_main_path_shapes():
    num_tiles = 100 * 67  # 1600x1066
    assert tc.key_dtype(262_144, num_tiles) == torch.int32
    assert tc.key_dtype(262_145, num_tiles) == torch.int64
    assert tc.key_dtype(250_000, num_tiles) == torch.int32
    assert (num_tiles << tc.pack_bits(250_000)).bit_length() == 31


# --- (b) the int32 route against an int64 reference --------------------------

def _case(kind):
    """(prep, geo, geo2, cull) of the 3DGS test scene or of the surfel one."""
    if kind == "surfel":
        xyz, scales, quats, opa, colors = surfel_scene(n=60, seed=13)
        prep = ts.preprocess_surfel(t(xyz), t(opa), port_camera(), colors_precomp=t(colors),
                                    scales=t(scales), quats=t(quats))
        ell, circ = ts.surfel_cull_ellipses(prep)
        return ts.surfel_prep_to_common(prep), ell, circ, True
    _, pt = both_preps(make_scene(n=200, seed=1))
    return pt, None, None, kind == "cull"


def _int64_reference(x):
    """The route as the int64 form gave it: keys re-packed in int64 from the
    plain version's decoded tile and rank, then one torch.sort."""
    keys, kept = expand_keys_plain(x)
    tile = (keys >> x.bits_g).to(torch.int64)
    rank = (keys & ((1 << x.bits_g) - 1)).to(torch.int64)
    s = torch.sort((tile << x.bits_g) | rank).values
    return s >> x.bits_g, s & ((1 << x.bits_g) - 1), kept


def _full_capacity_route(x, k2):
    """The route as the full-capacity form gave it: K1 over all k_cap slots,
    decoded from the int64 reference and cut to the stream's k2 slots ->
    (gid [k2], tile_start, tile_count)."""
    tile, rank, _ = _int64_reference(x._replace(slots=x.k_cap))
    start, count = tc._tile_bounds(tile[:k2], x.num_tiles)
    return x.order[rank[:k2]].to(torch.int32), start, count


@pytest.mark.parametrize("kind", ["no_cull", "cull", "surfel"])
@pytest.mark.parametrize("k_cap,stream_keys", [(1 << 14, 0), (256, 0), (1 << 14, 64),
                                               (1 << 20, 0)])
def test_int32_route_equals_the_int64_form(kind, k_cap, stream_keys):
    prep, geo, geo2, cull = _case(kind)
    x = expand_inputs(prep, W, H, k_cap, cull, geo, geo2)
    assert x.key_dtype == torch.int32 and x.end_bit == (x.num_tiles << x.bits_g).bit_length()
    keys, _ = expand_keys(x)
    assert keys.dtype == torch.int32 and int(keys.max()) < 1 << x.end_bit

    ref_tile, ref_rank, ref_kept = _int64_reference(x)
    st, sg, order, total, kept = tc.sorted_expansion(prep, W, H, k_cap, cull, geo, geo2)
    assert st.dtype == sg.dtype == torch.int32
    assert torch.equal(st.to(torch.int64), ref_tile) and torch.equal(sg.to(torch.int64), ref_rank)
    assert int(kept) == int(ref_kept)

    if not cull:  # route_stream always culls
        return
    cfg = RasterConfig(max_keys=k_cap, stream_keys=stream_keys)
    k2 = min(cfg.stream_cap, k_cap)
    r = tc.route_stream(prep, W, H, cfg, geo=geo, geo2=geo2)
    ref_gid, ref_start, ref_count = _full_capacity_route(x, k2)
    live = int(r.tile_count.sum())
    assert r.gid.shape == (min(k2, x.slots),)
    assert torch.equal(r.gid[:live], ref_gid[:live])
    assert torch.equal(r.tile_start, ref_start) and torch.equal(r.tile_count, ref_count)
    ref_dropped = max(int(total) - k_cap, 0) + max(int(ref_kept) - k2, 0)
    assert int(r.num_dropped_keys) == ref_dropped
    if k_cap == 256 or stream_keys:
        assert ref_dropped > 0
    if k_cap > SLOT_BUCKET:  # the sizing engages: one bucket for a few thousand keys
        assert x.slots == SLOT_BUCKET and int(total) < SLOT_BUCKET


def test_sort_keys_on_cpu_is_torch_sort():
    keys = torch.as_tensor(np.random.default_rng(3).integers(0, 1 << 30, 999), dtype=torch.int32)
    assert torch.equal(sort_keys(keys, 30), torch.sort(keys).values)
    assert torch.equal(sort_keys(keys.long(), 30), torch.sort(keys.long()).values)


# --- (c) past the int32 edge through the public route -----------------------

def test_int64_route_past_262144_rows_equals_the_int32_one():
    """262,145 rows at 1600x1066 need int64 keys, 262,144 fit in int32; the
    same few hundred live gaussians give the same stream either way."""
    rng = np.random.default_rng(21)
    n, live_n = 262_145, 300
    xyz = np.zeros((n, 3), np.float32)
    live = np.sort(rng.choice(n - 1, live_n, replace=False))  # the last row is dead
    xyz[live] = rng.uniform(-1.5, 1.5, (live_n, 3))
    scales = np.full((n, 3), 0.03, np.float32)
    scales[live] = np.exp(rng.normal(np.log(0.05), 0.5, (live_n, 3)))
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    quats[live] = rng.normal(size=(live_n, 4))
    opa = np.full(n, 0.5, np.float32)
    opa[live] = rng.uniform(0.05, 0.99, live_n)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    alive = np.zeros(n, bool)
    alive[live] = True
    cam = look_at_camera([0, 0.3, -4.0], [0, 0, 0], [0, 1, 0], 1.2, 0.9, 1600, 1066,
                         device="cpu")
    cfg = RasterConfig(max_keys=1 << 15)

    routes, dtypes = [], []
    for rows in (n, n - 1):
        prep = preprocess_plain(t(xyz[:rows]), t(opa[:rows]), cam,
                                colors_precomp=t(colors[:rows]), scales=t(scales[:rows]),
                                quats=t(quats[:rows]), alive=torch.as_tensor(alive[:rows]))
        dtypes.append(expand_inputs(prep, 1600, 1066, cfg.max_keys, True).key_dtype)
        routes.append(tc.route_stream(prep, 1600, 1066, cfg))
    assert dtypes == [torch.int64, torch.int32]
    wide, narrow = routes
    kept = int(wide.tile_count.sum())
    assert kept > 1000 and int(wide.num_dropped_keys) == 0
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


# --- (d) the key buffer's length: the frame's keys, not the capacity --------

B = SLOT_BUCKET


@pytest.mark.parametrize("total,k_cap,slots", [
    (0, 1 << 25, B),                  # nothing on screen: one bucket
    (1, 1 << 25, B),
    (B, 1 << 25, B),                  # on a bucket's edge
    (B + 1, 1 << 25, 2 * B),          # one past it
    (3_000_000, 1 << 25, 12 * B),     # a room-sized frame
    ((1 << 25) - 1, 1 << 25, 1 << 25),
    ((1 << 25) + 5, 1 << 25, 1 << 25),  # past the capacity: the capacity
    (0, 256, 256),                    # a capacity under one bucket
    (300, 256, 256),
    (B + 1, B + 7, B + 7),            # a capacity that is no whole bucket
])
def test_key_slots_follow_the_bucket_rule(total, k_cap, slots):
    assert key_slots(total, k_cap) == slots


def test_key_slots_take_at_most_128_lengths_at_2_25():
    lengths = {key_slots(total, 1 << 25) for total in range(0, (1 << 26) + B, B // 3)}
    assert len(lengths) == 128 and max(lengths) == 1 << 25


def _rect_prep(rects, width=1600, height=1066):
    """A hand-made Preprocessed with the given binning rects (tiles, half-open)
    and cull ellipses that admit every tile of their rect (a zero conic)."""
    n = len(rects)
    rect = torch.as_tensor(rects, dtype=torch.int32).reshape(n, 4)
    valid = (rect[:, 2] > rect[:, 0]) & (rect[:, 3] > rect[:, 1])
    center = (rect[:, :2] + rect[:, 2:]).to(torch.float32) * (tc.TILE / 2)
    return tc.Preprocessed(
        xy=center, depth=torch.arange(1, n + 1, dtype=torch.float32),
        conic=torch.zeros(n, 3), color=torch.full((n, 3), 0.5),
        opacity=torch.full((n,), 0.9), radii=valid.to(torch.int32) * 8, rect=rect,
        valid=valid)


def _edge_case(kind):
    """(rects, k_cap): 64 rects of 64 x 64 tiles hold exactly one bucket of
    keys; one more 1-tile rect passes it."""
    full = [(0, 0, 64, 64)] * 64
    if kind == "nothing_on_screen":
        return [(0, 0, 0, 0)] * 5, 3 * B
    if kind == "on_the_edge":
        return full, 3 * B
    if kind == "one_past":
        return full + [(99, 66, 100, 67)], 3 * B
    return full, 1000  # past the capacity


@pytest.mark.parametrize("kind,total,slots", [("nothing_on_screen", 0, B),
                                              ("on_the_edge", B, B),
                                              ("one_past", B + 1, 2 * B),
                                              ("past_the_capacity", B, 1000)])
def test_sized_route_at_the_bucket_edges(kind, total, slots):
    """The route sized by the frame's keys against the full-capacity decode
    where the length rule turns: gid on the live prefix, tile ranges and
    dropped keys equal; gid's length min(k2, slots); the counters add the
    slots and the capacity once per call."""
    rects, k_cap = _edge_case(kind)
    prep = _rect_prep(rects)
    x = expand_inputs(prep, 1600, 1066, k_cap, True)
    assert int(x.total) == total and x.slots == slots == key_slots(total, k_cap)
    cfg = RasterConfig(max_keys=k_cap)
    slots0, capacity0 = tc.route_stream.slots, tc.route_stream.capacity
    r = tc.route_stream(prep, 1600, 1066, cfg)
    assert (tc.route_stream.slots - slots0, tc.route_stream.capacity - capacity0) == (
        slots, k_cap)
    ref_gid, ref_start, ref_count = _full_capacity_route(x, k_cap)
    live = int(r.tile_count.sum())
    assert live == min(total, k_cap)  # the zero conic keeps every key
    assert r.gid.shape == (slots,)
    assert torch.equal(r.gid[:live], ref_gid[:live])
    assert torch.equal(r.tile_start, ref_start) and torch.equal(r.tile_count, ref_count)
    assert int(r.num_dropped_keys) == max(total - k_cap, 0)


@pytest.mark.parametrize("k_cap,stream_keys", [(1 << 20, 0), (1 << 20, 1000), (256, 0)])
def test_route_counters_add_slots_and_capacity_per_call(k_cap, stream_keys):
    prep, geo, geo2, _ = _case("surfel")
    cfg = RasterConfig(max_keys=k_cap, stream_keys=stream_keys)
    slots = expand_inputs(prep, W, H, k_cap, True, geo, geo2).slots
    slots0, capacity0 = tc.route_stream.slots, tc.route_stream.capacity
    for calls in (1, 2, 3):
        tc.route_stream(prep, W, H, cfg, geo=geo, geo2=geo2)
        assert tc.route_stream.slots - slots0 == calls * slots
        assert tc.route_stream.capacity - capacity0 == calls * k_cap
    assert slots == min(k_cap, B)


# --- (e) the mirror of K1's per-block search --------------------------------

def _starts(counts, k_cap):
    counts = torch.as_tensor(counts, dtype=torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    return torch.clamp_max(starts, k_cap).to(torch.int32), min(total, k_cap)


def _hand_made(kind):
    rng = np.random.default_rng(5)
    if kind == "zero_tail":        # 0-count invalid gaussians at the tail
        counts, k_cap = list(rng.integers(1, 9, 700)) + [0] * 300, 1 << 12
    elif kind == "long_runs":      # runs of several blocks: g_lo == g_hi
        counts, k_cap = [3, 2500, 1, 5000, 7] + [0] * 4, 1 << 14
    elif kind == "limit_inside":   # limit falls inside a block
        counts, k_cap = list(rng.integers(1, 40, 60)), 1 << 12
    elif kind == "k_cap_100":      # capacity below the keys, not a block multiple
        counts, k_cap = list(rng.integers(1, 30, 50)) + [0, 0], 100
    elif kind == "k_cap_777":
        counts, k_cap = list(rng.integers(1, 30, 80)) + [0], 777
    else:                          # zero-count gaussians in the middle too
        counts = list(rng.integers(0, 3, 4000))
        counts[1000:2500] = [0] * 1500
        counts[0] = 1
        k_cap = 1 << 12
    return _starts(counts, k_cap) + (k_cap,)


def _scene_starts(kind, k_cap):
    prep, geo, geo2, cull = _case(kind)
    x = expand_inputs(prep, W, H, k_cap, cull, geo, geo2)
    return x.starts, int(x.limit), k_cap


def _check_block_search(starts, limit, k_cap, bounded=True):
    owner, g_lo, g_hi = block_search_plain(starts, limit, k_cap)
    ks = torch.arange(k_cap, dtype=torch.int32)
    ref = torch.searchsorted(starts, ks, right=True).to(torch.int64) - 1
    assert torch.equal(owner[:limit], ref[:limit])
    assert bool((owner[limit:] == -1).all())
    live = g_lo >= 0
    assert int(live.sum()) == -(-limit // BLOCK_SLOTS)
    if bounded:
        assert int((g_hi - g_lo + 1)[live].max()) <= BLOCK_SLOTS + 1
    for k in [0, limit - 1, limit // 2, limit // 3]:
        assert warp_search_plain(starts.to(torch.int64), k) == int(ref[k])
    return g_lo, g_hi


@pytest.mark.parametrize("kind,k_cap", [("no_cull", 1 << 14), ("no_cull", 100),
                                         ("no_cull", 777), ("surfel", 1 << 14)])
def test_block_search_mirror_on_the_test_scenes(kind, k_cap):
    _check_block_search(*_scene_starts(kind, k_cap))


@pytest.mark.parametrize("kind", ["zero_tail", "long_runs", "limit_inside", "k_cap_100",
                                  "k_cap_777", "zero_runs"])
def test_block_search_mirror_on_hand_made_starts(kind):
    starts, limit, k_cap = _hand_made(kind)
    g_lo, g_hi = _check_block_search(starts, limit, k_cap, bounded=kind != "zero_runs")
    if kind == "long_runs":
        assert int(((g_lo == g_hi) & (g_lo >= 0)).sum()) >= 3
    if kind == "limit_inside":
        assert limit % BLOCK_SLOTS != 0 and limit < k_cap
    if kind == "zero_runs":  # gaussians without slots between the owners
        assert int((g_hi - g_lo).max()) > BLOCK_SLOTS
