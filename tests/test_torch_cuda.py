"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA inputs, at small edge-case shapes (empty tiles,
tiles of 255/256/257/600 keys, a single gaussian, an overflowing key
capacity, saturating pixels; for K1 both key widths, splats whose slots
span several of its blocks and capacities that cut its blocks; the
keys-only sort against torch.sort, and the whole route on the card against
the CPU with 32- and 64-bit keys; for the surfel kernels K4-K6 and K1's second
ellipse, random surfel scenes with tiles of several key batches, and
hand-built surfel streams: one emitting lane per warp, one surfel row in
every tile, pairs within a few ulps of alpha = 1/255; for K2 and K3 the
same kinds of hand-built 3DGS streams, and one whose keys every warp but
the first skips by the mask); the key buffers sized by the frame's keys
against the full-capacity stream at 1600x1066 (K2's and K4's images bit
for bit, the grad path's gradients within two runs' atomics spread); and
the SIFT matcher (pipeline/sift.py,
plain PyTorch) on the card against the CPU. Needs an NVIDIA GPU and nvcc;
skipped elsewhere. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from scorp_tpu_torch.core.camera import look_at_camera
from scorp_tpu_torch.ops.raster import (
    RasterConfig,
    preprocess_kernel,
    preprocess_surfel,
    rasterize,
    rasterize_surfel,
    route_stream,
    surfel_cull_ellipses,
    surfel_prep_to_common,
    surfel_table,
)
from scorp_tpu_torch.ops.raster import common as raster_common
from scorp_tpu_torch.ops.raster import expand as raster_expand
from scorp_tpu_torch.ops.raster.backward import composite_backward, composite_backward_plain
from scorp_tpu_torch.ops.raster.composite import composite, composite_plain
from scorp_tpu_torch.ops.raster.expand import expand_inputs, expand_keys, expand_keys_plain
from scorp_tpu_torch.ops.raster.sort import sort_keys
from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward, surfel_backward_plain
from scorp_tpu_torch.ops.raster.surfel_composite import (
    surfel_composite,
    surfel_composite_plain,
    surfel_composite_train,
)
from scorp_tpu_torch.pipeline import sift
from scorp_tpu_torch.render import default_raster_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scene(n, seed, device):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.uniform(-1, 1, (n, 3)),
        np.exp(rng.normal(np.log(0.06), 0.4, (n, 3))),
        rng.normal(size=(n, 4)),
        rng.uniform(0.05, 0.99, n),
        rng.normal(0, 0.5, (n, 16, 3)),
    ]
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _prep(n, seed, device, w=96, h=72):
    xyz, scales, quats, opa, shs = _scene(n, seed, device)
    cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, w, h, device=device)
    return preprocess_kernel(xyz, opa, cam, shs=shs, sh_degree=3, scales=scales, quats=quats), w, h


@pytest.mark.parametrize("n,k_cap,cull", [(1, 100, False), (1, 100, True),
                                          (300, 1 << 14, False), (300, 1 << 14, True),
                                          (300, 777, True)])
def test_expand_kernel_matches_plain(dev, n, k_cap, cull):
    prep, w, h = _prep(n, n + k_cap, dev)
    _check_expand_both_widths(expand_inputs(prep, w, h, k_cap, cull))


def _check_expand_both_widths(x):
    """K1 bit-identical to its plain version with the keys' own width and
    with 64-bit keys on the same inputs; both widths hold the same values."""
    assert x.key_dtype == torch.int32
    keys = []
    for xw in (x, x._replace(key_dtype=torch.int64)):
        keys_k, kept_k = expand_keys(xw)
        keys_p, kept_p = expand_keys_plain(xw)
        torch.cuda.synchronize()
        assert keys_k.dtype == xw.key_dtype
        assert torch.equal(keys_k, keys_p)
        assert int(kept_k) == int(kept_p)
        keys.append(keys_k)
    assert torch.equal(keys[0].long(), keys[1])
    return keys[0]


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("k_cap", [5333, 2049, 4096])
def test_expand_kernel_on_splats_spanning_blocks(dev, cull, k_cap):
    """A few large splats over hundreds of tiles (runs of slots across
    several 1024-slot blocks: g_lo == g_hi), among small ones; capacities
    that are no multiple of the block (5333), cut a run (2049) or end at a
    block's edge (4096), so limit falls inside a block or on its edge."""
    rng = np.random.default_rng(k_cap)
    n = 400
    xyz, scales, quats, opa, shs = _scene(n, 11, dev)
    big = torch.as_tensor(rng.uniform(0.4, 0.9, (4, 3)), dtype=torch.float32, device=dev)
    scales[:4] = big
    opa[:4] = 0.95
    w, h = 640, 480  # 40 x 30 = 1200 tiles
    cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, w, h, device=dev)
    prep = preprocess_kernel(xyz, opa, cam, shs=shs, sh_degree=3, scales=scales, quats=quats)
    x = expand_inputs(prep, w, h, k_cap, cull)
    counts = x.rect[:, 2:].long().sub(x.rect[:, :2].long()).prod(dim=1)
    assert int(counts.max()) > 1024 + 5  # a run longer than a block
    keys = _check_expand_both_widths(x)
    if k_cap != 4096:
        assert int(x.total) > k_cap  # the capacity cuts the keys: limit = k_cap
    assert int((keys != x.num_tiles << x.bits_g).sum()) > 0


def _stream(counts, tiles_x, seed, device, opaque=False):
    rng = np.random.default_rng(seed)
    k = int(sum(counts))
    tile = np.repeat(np.arange(len(counts)), counts)
    ox = (tile % tiles_x) * 16.0
    oy = (tile // tiles_x) * 16.0
    data = np.zeros((k, 10), np.float32)
    data[:, 0] = ox + rng.uniform(-8, 24, k)
    data[:, 1] = oy + rng.uniform(-8, 24, k)
    data[:, 2] = rng.uniform(0.05, 0.6, k)
    data[:, 3] = rng.normal(0, 0.1, k)
    data[:, 4] = rng.uniform(0.05, 0.6, k)
    data[:, 5:8] = rng.uniform(0, 1, (k, 3))
    data[:, 8] = np.sort(rng.uniform(1, 5, k))
    data[:, 9] = np.log2(np.full(k, 0.98) if opaque else rng.uniform(0.02, 0.99, k))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return (as_t(data, torch.float32), as_t(start, torch.int32),
            as_t(counts, torch.int32))


@pytest.mark.parametrize("opaque", [False, True])
def test_composite_kernel_matches_plain(dev, opaque):
    tiles_x = 4
    counts = [0, 1, 255, 256, 257, 600, 3, 0, 40, 1000, 17, 0]
    data, start, count = _stream(counts, tiles_x, 5, dev, opaque=opaque)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    got = composite(data, start, count, bg, tiles_x=tiles_x, track_ncontrib=True)
    ref = composite_plain(data, start, count, bg, tiles_x=tiles_x, track_ncontrib=True)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert float((got[3] == ref[3]).float().mean()) >= 0.999
    if opaque:
        assert float(got[2][count > 200].mean()) > 0.99  # saturated pixels stop early
    assert composite(data, start, count, bg, tiles_x=tiles_x)[3] is None


def test_rasterize_on_cuda_matches_cpu(dev):
    outs = []
    for device in (dev, torch.device("cpu")):
        xyz, scales, quats, opa, shs = _scene(400, 9, device)
        cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 96, 72,
                             device=device)
        outs.append(rasterize(xyz, opa, cam, torch.zeros(3, device=device), shs=shs,
                              sh_degree=3, scales=scales, quats=quats,
                              cfg=RasterConfig(max_keys=1 << 15)))
    for name in ("color", "alpha"):
        diff = (getattr(outs[0], name).cpu() - getattr(outs[1], name)).abs().max()
        assert float(diff) <= 5e-3, name
    assert float(outs[0].alpha.mean()) > 0.05


def test_wrappers_reject_bad_inputs(dev):
    data, start, count = _stream([5, 0, 3, 0], 2, 1, dev)
    bg = torch.zeros(3, device=dev)
    with pytest.raises(TypeError):
        composite(data.double(), start, count, bg, tiles_x=2)
    with pytest.raises(ValueError):
        composite(data.t().contiguous().t(), start, count, bg, tiles_x=2)
    with pytest.raises(ValueError):
        composite(data, start, count, bg, tiles_x=3)
    prep, w, h = _prep(10, 0, dev)
    x = expand_inputs(prep, w, h, 256, cull=True)
    with pytest.raises(TypeError):
        expand_keys(x._replace(geo=x.geo.double()))


@pytest.mark.parametrize("dtype,end_bit", [(torch.int32, 31), (torch.int32, 13),
                                           (torch.int64, 31), (torch.int64, 45)])
def test_sort_keys_matches_torch_sort(dev, dtype, end_bit):
    """The keys-only sort against torch.sort on random keys below
    2**end_bit, with runs of duplicates (K1's sentinels), and on 1 key."""
    rng = np.random.default_rng(end_bit)
    for n in (100_003, 1):
        keys = rng.integers(0, 1 << end_bit, n)
        keys[: n // 3] = (1 << end_bit) - 1
        rng.shuffle(keys)
        keys = torch.as_tensor(keys, dtype=dtype, device=dev)
        launches = sort_keys.launches
        got = sort_keys(keys, end_bit)
        torch.cuda.synchronize()
        assert sort_keys.launches == launches + 1
        assert got.dtype == dtype and torch.equal(got, torch.sort(keys).values)


def test_sort_keys_rejects_bad_inputs(dev):
    keys = torch.arange(10, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        sort_keys(keys.float(), 8)
    with pytest.raises(ValueError):
        sort_keys(keys, 32)
    with pytest.raises(ValueError):
        sort_keys(keys.view(2, 5), 8)


def test_route_stream_on_cuda_equals_cpu_for_both_key_widths(dev):
    """The public route (K1, the keys-only sort, the decode) on the card
    against the plain route on the CPU: 262,145 rows at 1600x1066 take
    64-bit keys, 262,144 take 32-bit ones, and the same few hundred live
    gaussians give one stream in all four runs."""
    rng = np.random.default_rng(21)
    n, live_n = 262_145, 400
    live = np.sort(rng.choice(n - 1, live_n, replace=False))
    arrays = [np.zeros((n, 3)), np.full((n, 3), 0.03), np.tile([1.0, 0, 0, 0], (n, 1)),
              np.full(n, 0.5), rng.uniform(0, 1, (n, 3))]
    arrays[0][live] = rng.uniform(-1.5, 1.5, (live_n, 3))
    arrays[1][live] = np.exp(rng.normal(np.log(0.05), 0.5, (live_n, 3)))
    arrays[2][live] = rng.normal(size=(live_n, 4))
    arrays[3][live] = rng.uniform(0.05, 0.99, live_n)
    alive = np.zeros(n, bool)
    alive[live] = True
    cfg = RasterConfig(max_keys=1 << 16)
    routes = []
    for device in (dev, torch.device("cpu")):
        xyz, scales, quats, opa, colors = (torch.as_tensor(a, dtype=torch.float32, device=device)
                                           for a in arrays)
        cam = look_at_camera([0, 0.3, -4.0], [0, 0, 0], [0, 1, 0], 1.2, 0.9, 1600, 1066,
                             device=device)
        for rows in (n, n - 1):
            prep = preprocess_kernel(xyz[:rows], opa[:rows], cam, colors_precomp=colors[:rows],
                                     scales=scales[:rows], quats=quats[:rows],
                                     alive=torch.as_tensor(alive[:rows], device=device))
            x = expand_inputs(prep, 1600, 1066, cfg.max_keys, True)
            assert x.key_dtype == (torch.int64 if rows == n else torch.int32)
            launches = sort_keys.launches
            routes.append([v.cpu() for v in route_stream(prep, 1600, 1066, cfg)])
            assert sort_keys.launches == launches + (device.type == "cuda")
    ref = routes[-1]
    assert int(ref[2].sum()) > 1000 and int(ref[3]) == 0
    for r in routes[:-1]:
        for a, b in zip(r, ref):
            assert torch.equal(a, b)


def test_composite_rejects_misaligned_rows(dev):
    """K2 copies stream rows in 8-byte pieces: rows that start 4 bytes into
    an allocation are refused, not read wrongly."""
    data, start, count = _stream([5, 0, 3, 0], 2, 1, dev)
    shifted = torch.empty(data.numel() + 1, device=dev)[1:].view(data.shape)
    shifted.copy_(data)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="aligned"):
        composite(shifted, start, count, torch.zeros(3, device=dev), tiles_x=2)


def _backward_inputs(counts, tiles_x, seed, device, n_rows, opaque=False):
    """A stream, its gaussian rows (repeated, so atomics collide), K2's
    residuals on it and cotangents drawn from the seed."""
    data, start, count = _stream(counts, tiles_x, seed, device, opaque=opaque)
    rng = np.random.default_rng(seed + 1)
    gid = torch.as_tensor(rng.integers(0, n_rows, data.shape[0]), dtype=torch.int32,
                          device=device)
    bg = torch.tensor([0.2, 0.3, 0.4], device=device)
    _, _, _, n_contrib, t_final = composite(data, start, count, bg, tiles_x=tiles_x,
                                            track_ncontrib=True, with_t_final=True)
    n_tiles = len(counts)
    g = [torch.as_tensor(rng.normal(size=(n_tiles, c, 256)), dtype=torch.float32,
                         device=device) for c in (3, 1, 1)]
    return (data, gid, start, count, bg, *g, t_final, n_contrib, n_rows)


@pytest.mark.parametrize("size", ["edge_cases", "many_tiles"])
def test_backward_kernel_matches_plain(dev, size):
    if size == "edge_cases":
        tiles_x, counts, n_rows, opaque = 4, [0, 1, 255, 256, 257, 600, 3, 0, 40, 1000, 17, 0], 50, True
    else:
        tiles_x, n_rows, opaque = 8, 3000, False
        counts = np.random.default_rng(3).integers(0, 900, 64).tolist()
    args = _backward_inputs(counts, tiles_x, 11, dev, n_rows, opaque=opaque)
    got = composite_backward(*args, tiles_x=tiles_x)
    ref = composite_backward_plain(*args, tiles_x=tiles_x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    # atomics add in a run-dependent order: per column within 1e-4 of the
    # column's largest magnitude
    scale = ref.abs().amax(dim=0)
    assert bool(((got - ref).abs() <= 1e-4 * scale + 1e-12).all())
    assert float(scale.min()) > 0.0  # every row of the table got gradient


def test_rasterize_backward_on_cuda_matches_cpu(dev):
    grads = []
    for device in (dev, torch.device("cpu")):
        xyz, scales, quats, opa, shs = (x.requires_grad_(True) for x in _scene(300, 4, device))
        cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 96, 72,
                             device=device)
        out = rasterize(xyz, opa, cam, torch.zeros(3, device=device), shs=shs, sh_degree=3,
                        scales=scales, quats=quats, cfg=RasterConfig(max_keys=1 << 15))
        (out.color.square().mean() + out.alpha.mean() + 0.1 * out.depth_accum.mean()).backward()
        grads.append([x.grad.cpu() for x in (xyz, scales, quats, opa, shs)])
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1e-8)
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


def test_backward_wrapper_rejects_bad_inputs(dev):
    args = list(_backward_inputs([5, 0, 3, 0], 2, 1, dev, 10))
    with pytest.raises(TypeError):
        composite_backward(*[args[0].double()] + args[1:], tiles_x=2)
    with pytest.raises(TypeError):
        composite_backward(*args[:1] + [args[1].long()] + args[2:], tiles_x=2)
    with pytest.raises(ValueError):
        composite_backward(*args[:5] + [args[5][:, :2].contiguous()] + args[6:], tiles_x=2)
    with pytest.raises(ValueError):
        composite_backward(*args, tiles_x=3)


# --- the key buffers sized by the frame's keys -------------------------------

SIZED_N, SIZED_W, SIZED_H = 100_000, 1600, 1066


def _sized_scene(device, grad=False):
    """100k small primitives at 1600x1066: ~0.8M keys, so the key buffers
    take 3-4 buckets of default_raster_config's 2^21 slots."""
    xyz, scales, quats, opa, shs = _scene(SIZED_N, 17, device)
    arrays = [xyz, scales / 6.0, quats, opa, shs]
    cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, SIZED_W, SIZED_H,
                         device=device)
    return [a.clone().requires_grad_(grad) for a in arrays], cam


def _full_capacity(monkeypatch):
    """Every key buffer at the capacity's length, as before the sizing."""
    monkeypatch.setattr(raster_expand, "key_slots", lambda total, k_cap: k_cap)


def _check_sized_route(x, route, cfg):
    """The sized route against the full-capacity one built by hand, as
    chip_smoke.check_route builds it; returns that stream (gid, start, count)."""
    import chip_smoke

    gid, start, count, dropped = chip_smoke.full_capacity_route(x, cfg)
    live = int(route.tile_count.sum())
    assert x.slots < x.k_cap and route.gid.shape == (min(gid.shape[0], x.slots),)
    assert torch.equal(route.gid[:live], gid[:live])
    assert torch.equal(route.tile_start, start) and torch.equal(route.tile_count, count)
    assert int(route.num_dropped_keys) == int(dropped) == 0
    return gid, start, count


def _grads_within_spread(run, monkeypatch):
    """The grad path's gradients at the sized buffers (twice: the atomics'
    own run-to-run spread) and at the full capacity: each input's gap to
    the full-capacity run within twice the spread of the two sized runs,
    plus 1e-6 of its largest gradient."""
    sized = [run(), run()]
    _full_capacity(monkeypatch)
    full = run()
    for a, b, f in zip(*sized, full):
        scale = float(f.abs().max())
        spread = float((a - b).abs().max())
        assert scale > 0.0
        assert float((a - f).abs().max()) <= 2.0 * spread + 1e-6 * scale


def test_sized_stream_gives_k2_the_full_capacity_images(dev):
    (xyz, scales, quats, opa, shs), cam = _sized_scene(dev)
    cfg = default_raster_config(SIZED_N)
    prep = preprocess_kernel(xyz, opa, cam, shs=shs, sh_degree=3, scales=scales, quats=quats)
    x = expand_inputs(prep, SIZED_W, SIZED_H, cfg.max_keys, True)
    slots0, cap0 = route_stream.slots, route_stream.capacity
    route = route_stream(prep, SIZED_W, SIZED_H, cfg)
    assert (route_stream.slots - slots0, route_stream.capacity - cap0) == (x.slots, x.k_cap)
    gid, start, count = _check_sized_route(x, route, cfg)
    table = raster_common.stream_table(prep)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    tiles_x = SIZED_W // 16
    sized = composite(table[route.gid].contiguous(), route.tile_start, route.tile_count, bg,
                      tiles_x=tiles_x, track_ncontrib=True)
    full = composite(table[gid].contiguous(), start, count, bg, tiles_x=tiles_x,
                     track_ncontrib=True)
    assert float(sized[2].mean()) > 0.05
    for a, b in zip(sized, full):
        assert torch.equal(a, b)


def test_sized_stream_gives_k4_the_full_capacity_images(dev):
    (xyz, scales, quats, opa, shs), cam = _sized_scene(dev)
    cfg = default_raster_config(SIZED_N)
    prep = preprocess_surfel(xyz, opa, cam, shs=shs, sh_degree=3, scales=scales[:, :2],
                             quats=quats)
    ell, circ = surfel_cull_ellipses(prep)
    common = surfel_prep_to_common(prep)
    x = expand_inputs(common, SIZED_W, SIZED_H, cfg.max_keys, True, ell, circ)
    route = route_stream(common, SIZED_W, SIZED_H, cfg, geo=ell, geo2=circ)
    gid, start, count = _check_sized_route(x, route, cfg)
    table = surfel_table(prep)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    tiles_x = SIZED_W // 16
    sized = surfel_composite(table[route.gid].contiguous(), route.tile_start,
                             route.tile_count, bg, tiles_x=tiles_x)
    full = surfel_composite(table[gid].contiguous(), start, count, bg, tiles_x=tiles_x)
    assert float(sized[1].mean()) > 0.05
    for a, b in zip(sized, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("primitive", ["3dgs", "2dgs"])
def test_sized_stream_eval_renders_equal_the_full_capacity_ones(dev, monkeypatch, primitive):
    """rasterize / rasterize_surfel without grad, whole: every output bit
    for bit at the sized buffers and at the full capacity."""
    (xyz, scales, quats, opa, shs), cam = _sized_scene(dev)
    cfg = default_raster_config(SIZED_N)
    bg = torch.zeros(3, device=dev)

    def run():
        if primitive == "3dgs":
            return rasterize(xyz, opa, cam, bg, shs=shs, sh_degree=3, scales=scales,
                             quats=quats, cfg=cfg)
        return rasterize_surfel(xyz, opa, cam, bg, shs=shs, sh_degree=3,
                                scales=scales[:, :2], quats=quats, cfg=cfg)

    slots0, cap0 = route_stream.slots, route_stream.capacity
    sized = run()
    assert route_stream.slots - slots0 < route_stream.capacity - cap0 == cfg.max_keys
    _full_capacity(monkeypatch)
    full = run()
    assert int(sized.num_dropped_keys) == int(full.num_dropped_keys) == 0
    for a, b in zip(sized, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("primitive", ["3dgs", "2dgs"])
def test_sized_stream_grad_path_gives_the_full_capacity_gradients(dev, monkeypatch, primitive):
    """One grad-path step (K2 + K3, or K5 + K6) at the sized buffers and at
    the full capacity: the gradients of every input agree within the
    atomics' spread between two runs of the same stream."""
    cfg = default_raster_config(SIZED_N)
    bg = torch.zeros(3, device=dev)

    def run():
        inputs, cam = _sized_scene(dev, grad=True)
        xyz, scales, quats, opa, shs = inputs
        if primitive == "3dgs":
            out = rasterize(xyz, opa, cam, bg, shs=shs, sh_degree=3, scales=scales,
                            quats=quats, cfg=cfg)
            loss = out.color.square().mean() + out.alpha.mean() + 0.1 * out.depth_accum.mean()
        else:
            out = rasterize_surfel(xyz, opa, cam, bg, shs=shs, sh_degree=3,
                                   scales=scales[:, :2], quats=quats, cfg=cfg)
            loss = (out.color.square().mean() + out.alpha.mean() + 0.1 * out.depth_accum.mean()
                    + 0.1 * out.normal.square().mean() + 0.05 * out.depth_median.mean()
                    + 10.0 * out.distortion.mean())
        assert int(out.num_dropped_keys) == 0
        loss.backward()
        return [x.grad for x in inputs]

    _grads_within_spread(run, monkeypatch)


# --- the surfel path: K1 with its second ellipse, K4, K5, K6 ----------------

def _surfel_route(n, seed, device, opaque=False, w=96, h=72):
    """A random surfel scene's table [N, 21] and routing (K1 with the conic
    and the circle), on `device`."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.uniform(-1, 1, (n, 3)),
        np.exp(rng.normal(np.log(0.08), 0.5, (n, 2))),
        rng.normal(size=(n, 4)),
        np.full(n, 0.98) if opaque else rng.uniform(0.05, 0.99, n),
        rng.uniform(0, 1, (n, 3)),
    ]
    xyz, scales, quats, opa, colors = (torch.as_tensor(a, dtype=torch.float32, device=device)
                                       for a in arrays)
    cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, w, h, device=device)
    prep = preprocess_surfel(xyz, opa, cam, colors_precomp=colors, scales=scales, quats=quats)
    ell, circ = surfel_cull_ellipses(prep)
    common = surfel_prep_to_common(prep)
    route = route_stream(common, w, h, RasterConfig(max_keys=1 << 16), geo=ell, geo2=circ)
    return surfel_table(prep), route, (common, ell, circ, w, h)


@pytest.mark.parametrize("n,k_cap", [(1, 100), (300, 1 << 14), (3000, 1 << 16), (300, 777)])
def test_expand_kernel_with_second_ellipse_matches_plain(dev, n, k_cap):
    _, _, (common, ell, circ, w, h) = _surfel_route(n, n + k_cap, dev)
    x = expand_inputs(common, w, h, k_cap, True, ell, circ)
    keys = _check_expand_both_widths(x)
    kept = int((keys != x.num_tiles << x.bits_g).sum())
    # the union keeps at least what the conic alone keeps
    assert kept >= int(expand_keys(x._replace(geo2=None))[1])


def _check_surfel_forward(got, ref, train):
    """Every float channel within 1e-5 (absolute and relative: depth and
    median are view depths ~3.5), the positions equal on >= 99.9% of pixels."""
    for a, b in zip(got[:6], ref[:6]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    if train:
        for a, b in zip(got[6:8], ref[6:8]):
            assert float((a == b).float().mean()) >= 0.999
        for a, b in zip(got[8:], ref[8:]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,opaque", [(300, False), (3000, False), (3000, True)])
def test_surfel_composite_kernels_match_plain(dev, n, opaque):
    table, route, _ = _surfel_route(n, 7, dev, opaque=opaque)
    data = table[route.gid].contiguous()
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    args = (data, route.tile_start, route.tile_count, bg)
    tiles_x = 6
    assert int(route.tile_count.max()) > (256 if n == 3000 else 0)  # several key batches
    k4 = surfel_composite(*args, tiles_x=tiles_x)
    k5 = surfel_composite_train(*args, tiles_x=tiles_x)
    torch.cuda.synchronize()
    _check_surfel_forward(k4, surfel_composite_plain(*args, tiles_x=tiles_x), False)
    _check_surfel_forward(k5, surfel_composite_plain(*args, tiles_x=tiles_x, train=True), True)
    for a, b in zip(k4, k5[:6]):
        assert torch.equal(a, b)
    if opaque:
        assert float(k5[1].mean()) > 0.5 and int((k5[10] < 1e-3).sum()) > 0  # pixels stop


@pytest.mark.parametrize("n,opaque", [(300, False), (3000, True)])
def test_surfel_backward_kernel_matches_plain(dev, n, opaque):
    table, route, _ = _surfel_route(n, 8, dev, opaque=opaque)
    data = table[route.gid].contiguous()
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    tiles_x = 6
    res = surfel_composite_train(data, route.tile_start, route.tile_count, bg, tiles_x=tiles_x)
    rng = np.random.default_rng(9)
    g = [torch.as_tensor(rng.normal(size=(route.tile_start.shape[0], c, 256)),
                         dtype=torch.float32, device=dev) for c in (3, 1, 1, 3, 1, 1)]
    n_contrib, n_med, wm, wm2, t_final = res[6:]
    args = (data, route.gid, route.tile_start, route.tile_count, bg, *g, t_final, n_contrib,
            n_med, wm, wm2, table.shape[0])
    got = surfel_backward(*args, tiles_x=tiles_x)
    ref = surfel_backward_plain(*args, tiles_x=tiles_x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    # atomics add in a run-dependent order: per column within 1e-4 of the
    # column's largest magnitude
    scale = ref.abs().amax(dim=0)
    assert bool(((got - ref).abs() <= 1e-4 * scale + 1e-12).all())
    assert float(scale.min()) > 0.0  # every column got gradient


def test_rasterize_surfel_backward_on_cuda_matches_cpu(dev):
    grads, outs = [], []
    for device in (dev, torch.device("cpu")):
        rng = np.random.default_rng(12)
        arrays = [rng.uniform(-1, 1, (400, 3)), np.exp(rng.normal(np.log(0.08), 0.4, (400, 2))),
                  rng.normal(size=(400, 4)), rng.uniform(0.05, 0.95, 400),
                  rng.normal(0, 0.5, (400, 16, 3))]
        xyz, scales, quats, opa, shs = (torch.as_tensor(a, dtype=torch.float32, device=device)
                                        .requires_grad_(True) for a in arrays)
        cam = look_at_camera([0, 0.3, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.7, 96, 72,
                             device=device)
        out = rasterize_surfel(xyz, opa, cam, torch.zeros(3, device=device), shs=shs,
                               sh_degree=3, scales=scales, quats=quats,
                               cfg=RasterConfig(max_keys=1 << 15))
        (out.color.square().mean() + out.alpha.mean() + 0.1 * out.depth_accum.mean()
         + 0.1 * out.normal.square().mean() + 0.05 * out.depth_median.mean()
         + 10.0 * out.distortion.mean()).backward()
        grads.append([x.grad.cpu() for x in (xyz, scales, quats, opa, shs)])
        outs.append(out.color.detach().cpu())
    assert float((outs[0] - outs[1]).abs().max()) <= 5e-3
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1e-8)
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


def _disc_rows(rng, cx, cy, a, b, opacity, tilt=1e-3, angle=True):
    """Stream rows of discs centred at (cx, cy) with half-axes a and b in
    pixels: u and v are the rotated, scaled offsets from the centre over
    s_z = 1 + a small tilt, the depth row near z = 1..5."""
    n = cx.shape[0]
    th = rng.uniform(0, np.pi, n) if angle else np.zeros(n)
    c, s = np.cos(th), np.sin(th)
    rows = np.zeros((n, 21))
    rows[:, 0:3] = np.stack([c / a, s / a, -(cx * c + cy * s) / a], 1)
    rows[:, 3:6] = np.stack([-s / b, c / b, (cx * s - cy * c) / b], 1)
    t1, t2 = rng.normal(0, tilt, n), rng.normal(0, tilt, n)
    rows[:, 6:9] = np.stack([t1, t2, 1.0 - t1 * cx - t2 * cy], 1)
    rows[:, 9:11] = rng.normal(0, 0.05, (n, 2))
    rows[:, 11] = rng.uniform(1, 5, n)
    rows[:, 12], rows[:, 13] = cx, cy
    rows[:, 14:17] = rng.uniform(0, 1, (n, 3))
    rows[:, 17:20] = rng.normal(0, 1, (n, 3))
    rows[:, 20] = np.log2(opacity)
    return rows.astype(np.float32)


SYNTH_TILES_X, SYNTH_COUNTS = 4, [300, 0, 600, 257, 40, 1, 520, 256, 255, 90, 700, 12]


def _synthetic_surfel_stream(kind, device, seed=3):
    """A hand-built surfel stream over a 4x3-tile image with tiles of 0 to
    700 keys (several 256-key batches): (data [K, 21], gid [K], tile_start,
    tile_count, n_rows).
    - single_lane: pinpoint discs (opacity 0.008) on one pixel each, so in
      a warp that emits for a key exactly one lane does;
    - shared_row: one disc covering the whole image in every tile as
      surfel row 0 (every tile's flush adds into that row), with random
      discs from 0.3 to 6 pixels (both branches of rho, all 21 gradient
      columns);
    - boundary: discs whose alpha lands within a few ulps of 1/255 at some
      pixels, through rho3d (axis-aligned discs scaled onto the threshold)
      and through rho2d (tiny discs whose opacity puts the threshold at
      an integer pixel distance)."""
    rng = np.random.default_rng(seed)
    counts = np.array(SYNTH_COUNTS)
    k = int(counts.sum())
    tile = np.repeat(np.arange(counts.size), counts)
    ox = (tile % SYNTH_TILES_X) * 16.0
    oy = (tile // SYNTH_TILES_X) * 16.0
    gid = rng.permutation(k)
    if kind == "single_lane":
        cx = ox + rng.integers(0, 16, k)
        cy = oy + rng.integers(0, 16, k)
        data = _disc_rows(rng, cx, cy, np.full(k, 0.2), np.full(k, 0.2), np.full(k, 0.008))
    elif kind == "shared_row":
        cx, cy = ox + rng.uniform(-8, 24, k), oy + rng.uniform(-8, 24, k)
        a, b = np.exp(rng.uniform(np.log(0.3), np.log(6.0), (2, k)))
        data = _disc_rows(rng, cx, cy, a, b, rng.uniform(0.05, 0.9, k))
        big = _disc_rows(rng, np.array([32.0]), np.array([24.0]), np.array([60.0]),
                         np.array([45.0]), np.array([0.3]))
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slots = [s + rng.integers(0, c) for s, c in zip(start, counts) if c > 0]
        data[slots] = big
        gid = rng.integers(1, k, k)
        gid[slots] = 0
    else:
        lopa = rng.uniform(-7.9, 0.0, k)
        ulps = 1.0 + rng.integers(-16, 17, k) * 2.0 ** -22
        cx = ox + rng.integers(0, 16, k)
        cy = oy + rng.integers(0, 16, k)
        d2 = rng.choice([1.0, 2.0, 4.0, 5.0, 8.0, 25.0], k)
        r_thr = 2 * np.log(2) * (lopa + np.log2(255))
        a = np.sqrt(d2 / r_thr) * ulps                      # rho3d = d2 / a^2 on the threshold
        data = _disc_rows(rng, cx, cy, a, a, 2.0 ** lopa, tilt=0.0, angle=False)
        tiny = rng.uniform(size=k) < 0.5                    # rho2d = 2 d2 on the threshold
        d2t = rng.choice([1.0, 2.0, 4.0, 5.0], k)
        lopa_t = (2 * d2t / (2 * np.log(2)) - np.log2(255)) * ulps
        data[tiny] = _disc_rows(rng, cx[tiny], cy[tiny], np.full(k, 0.05)[tiny],
                                np.full(k, 0.05)[tiny], 2.0 ** lopa_t[tiny])
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    return (as_t(data, torch.float32), as_t(gid, torch.int32), as_t(start, torch.int32),
            as_t(counts, torch.int32), int(gid.max()) + 1)


def _synthetic_slots(data, start, count, n_contrib):
    """Per (tile, key, warp): how many lanes clear the exact tests below
    their n_contrib (K6's emitting lanes), and the alpha of every pair."""
    from scorp_tpu_torch.ops.raster.composite import pixel_coords
    from scorp_tpu_torch.ops.raster.surfel_composite import surfel_hit

    c = count.long()
    j = torch.arange(int(c.max()), device=data.device)
    idx = (start.long()[:, None] + j[None, :]).clamp_max(data.shape[0] - 1)
    px, py = pixel_coords(c.shape[0], SYNTH_TILES_X, torch.float32, data.device)
    hit = surfel_hit(data[idx], px, py)
    emit = ((j[None, :] < c[:, None])[..., None] & (j[None, :, None] < n_contrib.long()[:, None])
            & (hit["alpha"] >= 1 / 255) & (hit["z"] >= 0.2))
    return emit.view(c.shape[0], j.shape[0], 8, 32).sum(-1), hit["alpha"][j[None, :] < c[:, None]]


@pytest.mark.parametrize("kind", ["single_lane", "shared_row", "boundary"])
def test_surfel_kernels_on_synthetic_streams(dev, kind):
    """K4/K5 against their plain versions (and K4 == K5), then K6 against
    its plain version on K5's residuals, on the hand-built streams."""
    data, gid, start, count, n_rows = _synthetic_surfel_stream(kind, dev)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    args = (data, start, count, bg)
    k4 = surfel_composite(*args, tiles_x=SYNTH_TILES_X)
    k5 = surfel_composite_train(*args, tiles_x=SYNTH_TILES_X)
    torch.cuda.synchronize()
    _check_surfel_forward(k4, surfel_composite_plain(*args, tiles_x=SYNTH_TILES_X), False)
    _check_surfel_forward(k5, surfel_composite_plain(*args, tiles_x=SYNTH_TILES_X, train=True),
                          True)
    for a, b in zip(k4, k5[:6]):
        assert torch.equal(a, b)

    n_contrib, n_med, wm, wm2, t_final = k5[6:]
    rng = np.random.default_rng(5)
    g = [torch.as_tensor(rng.normal(size=(len(SYNTH_COUNTS), c, 256)), dtype=torch.float32,
                         device=dev) for c in (3, 1, 1, 3, 1, 1)]
    k6_args = (data, gid, start, count, bg, *g, t_final, n_contrib, n_med, wm, wm2, n_rows)
    got = surfel_backward(*k6_args, tiles_x=SYNTH_TILES_X)
    ref = surfel_backward_plain(*k6_args, tiles_x=SYNTH_TILES_X)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = ref.abs().amax(dim=0)
    assert bool(((got - ref).abs() <= 1e-4 * scale + 1e-12).all())

    lanes, alpha = _synthetic_slots(data, start, count, n_contrib[:, 0])
    if kind == "single_lane":
        assert int(lanes.max()) == 1 and int((lanes == 1).sum()) > 1000
    elif kind == "shared_row":
        assert float(scale.min()) > 0.0  # all 21 columns
        # the row every tile flushes into (the big disc never takes the
        # low-pass branch, whose columns are 12 and 13)
        assert bool((ref[0, [c for c in range(21) if c not in (12, 13)]] != 0).all())
    else:
        ulp = float(np.spacing(np.float32(1 / 255)))
        near = (alpha - 1 / 255).abs() <= 16 * ulp
        assert int((near & (alpha >= 1 / 255)).sum()) > 50
        assert int((near & (alpha < 1 / 255)).sum()) > 50


def test_surfel_wrappers_reject_bad_inputs(dev):
    table, route, _ = _surfel_route(50, 1, dev)
    data = table[route.gid].contiguous()
    bg = torch.zeros(3, device=dev)
    with pytest.raises(TypeError):
        surfel_composite(data.double(), route.tile_start, route.tile_count, bg, tiles_x=6)
    with pytest.raises(ValueError):
        surfel_composite_train(data[:, :10].contiguous(), route.tile_start, route.tile_count,
                               bg, tiles_x=6)
    with pytest.raises(ValueError):
        surfel_composite(data, route.tile_start, route.tile_count, bg, tiles_x=7)
    res = surfel_composite_train(data, route.tile_start, route.tile_count, bg, tiles_x=6)
    g = [torch.zeros(route.tile_start.shape[0], c, 256, device=dev) for c in (3, 1, 1, 3, 1, 1)]
    args = [data, route.gid, route.tile_start, route.tile_count, bg, *g, res[10], *res[6:10],
            table.shape[0]]
    with pytest.raises(TypeError):
        surfel_backward(*args[:12] + [res[6].float()] + args[13:], tiles_x=6)
    with pytest.raises(ValueError):
        surfel_backward(*args[:5] + [g[0][:, :2].contiguous()] + args[6:], tiles_x=6)


# --- K2 and K3 on hand-built 3DGS streams ------------------------------------

def _gauss_rows(rng, cx, cy, l11, l21, l22, opacity):
    """Stream rows [n, 10] of gaussians centred at (cx, cy) with conic
    Cholesky rows l11, l21, l22 (u = l11 dx + l21 dy, v = l22 dy), random
    colours and depths sorted front to back."""
    n = cx.shape[0]
    rows = np.zeros((n, 10))
    rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4] = cx, cy, l11, l21, l22
    rows[:, 5:8] = rng.uniform(0, 1, (n, 3))
    rows[:, 8] = np.sort(rng.uniform(1, 5, n))
    rows[:, 9] = np.log2(opacity)
    return rows.astype(np.float32)


def _synthetic_gauss_stream(kind, device, seed=3):
    """A hand-built 3DGS stream over SYNTH_COUNTS' 4x3-tile image (tiles of
    0 to 700 keys, several 256-key batches): (data [K, 10], gid [K],
    tile_start, tile_count, n_rows).
    - single_lane: pinpoint gaussians (opacity 0.008, alpha >= 1/255 only on
      their centre pixel), so in a warp that emits for a key exactly one
      lane does;
    - shared_row: one gaussian covering the whole image as row 0 in every
      tile (every tile's flush adds into that row), among random ones from
      0.5 to 8 pixels;
    - masked: gaussians confined to each tile's first two pixel rows and
      keys below 1/255 everywhere, so warps 1-7 skip every key by the mask;
    - threshold: axis-aligned gaussians whose alpha lands within a few ulps
      of 1/255 at integer pixel offsets."""
    rng = np.random.default_rng(seed)
    counts = np.array(SYNTH_COUNTS)
    k = int(counts.sum())
    tile = np.repeat(np.arange(counts.size), counts)
    ox = (tile % SYNTH_TILES_X) * 16.0
    oy = (tile // SYNTH_TILES_X) * 16.0
    gid = rng.permutation(k)
    zeros = np.zeros(k)
    if kind == "single_lane":
        cx, cy = ox + rng.integers(0, 16, k), oy + rng.integers(0, 16, k)
        data = _gauss_rows(rng, cx, cy, zeros + 2.0, zeros, zeros + 2.0, zeros + 0.008)
    elif kind == "shared_row":
        cx, cy = ox + rng.uniform(-8, 24, k), oy + rng.uniform(-8, 24, k)
        l11, l22 = 1.0 / np.exp(rng.uniform(np.log(0.5), np.log(8.0), (2, k)))
        data = _gauss_rows(rng, cx, cy, l11, rng.normal(0, 0.1, k), l22,
                           rng.uniform(0.05, 0.9, k))
        big = _gauss_rows(rng, np.array([32.0]), np.array([24.0]), np.array([0.02]),
                          np.array([0.001]), np.array([0.02]), np.array([0.3]))
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slots = [s + rng.integers(0, c) for s, c in zip(start, counts) if c > 0]
        data[slots] = big
        gid = rng.integers(1, k, k)
        gid[slots] = 0
    elif kind == "masked":
        cx, cy = ox + rng.uniform(0, 15, k), oy + rng.uniform(0, 1, k)
        opacity = np.where(rng.uniform(size=k) < 0.2, 0.003, rng.uniform(0.05, 0.9, k))
        data = _gauss_rows(rng, cx, cy, rng.uniform(0.5, 3.0, k), rng.normal(0, 0.1, k),
                           zeros + 6.0, opacity)
    else:
        lopa = rng.uniform(-7.9, 0.0, k)
        ulps = 1.0 + rng.integers(-16, 17, k) * 2.0 ** -22
        d2 = rng.choice([1.0, 2.0, 4.0, 5.0, 8.0, 25.0], k)
        a = np.sqrt(2 * (lopa + np.log2(255)) / d2) * ulps       # a² d2 on the threshold
        cx, cy = ox + rng.integers(0, 16, k), oy + rng.integers(0, 16, k)
        data = _gauss_rows(rng, cx, cy, a, zeros, a, 2.0 ** lopa)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    return (as_t(data, torch.float32), as_t(gid, torch.int32), as_t(start, torch.int32),
            as_t(counts, torch.int32), int(gid.max()) + 1)


@pytest.mark.parametrize("kind", ["single_lane", "shared_row", "masked", "threshold"])
def test_gauss_kernels_on_synthetic_streams(dev, kind):
    """K2 bit-identical to its plain version (every output, n_contrib on
    every pixel), then K3 against its plain version on K2's residuals, per
    column within 1e-4 of the column's largest value."""
    from scorp_tpu_torch.ops.raster.composite import gauss_alpha, gauss_warp_mask, pixel_coords

    data, gid, start, count, n_rows = _synthetic_gauss_stream(kind, dev)
    bg = torch.tensor([0.2, 0.3, 0.4], device=dev)
    args = (data, start, count, bg)
    got = composite(*args, tiles_x=SYNTH_TILES_X, track_ncontrib=True, with_t_final=True)
    ref = composite_plain(*args, tiles_x=SYNTH_TILES_X, track_ncontrib=True, with_t_final=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

    n_contrib, t_final = got[3], got[4]
    rng = np.random.default_rng(5)
    g = [torch.as_tensor(rng.normal(size=(len(SYNTH_COUNTS), c, 256)), dtype=torch.float32,
                         device=dev) for c in (3, 1, 1)]
    k3_args = (data, gid, start, count, bg, *g, t_final, n_contrib, n_rows)
    d_got = composite_backward(*k3_args, tiles_x=SYNTH_TILES_X)
    d_ref = composite_backward_plain(*k3_args, tiles_x=SYNTH_TILES_X)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d_got).all())
    scale = d_ref.abs().amax(dim=0)
    assert bool(((d_got - d_ref).abs() <= 1e-4 * scale + 1e-12).all())

    # what each stream is built to show, from the plain mirrors
    c = count.long()
    j = torch.arange(int(c.max()), device=dev)
    valid = j[None, :] < c[:, None]
    rows = data[(start.long()[:, None] + j[None, :]).clamp_max(data.shape[0] - 1)]
    px, py = pixel_coords(c.shape[0], SYNTH_TILES_X, torch.float32, dev)
    alpha = gauss_alpha(rows, px, py)["alpha"]
    lanes = ((alpha >= 1 / 255) & valid[..., None]).view(c.shape[0], -1, 8, 32).sum(-1)
    if kind == "single_lane":
        assert int(lanes.max()) == 1 and int((lanes == 1).sum()) > 1000
    elif kind == "shared_row":
        assert bool((d_ref[0] != 0).all()) and float(scale.min()) > 0.0
    elif kind == "masked":
        t = torch.arange(c.shape[0], device=dev)
        mask = gauss_warp_mask(rows, (t % SYNTH_TILES_X) * 16, (t // SYNTH_TILES_X) * 16)
        assert not bool(mask[..., 1:][valid].any()) and bool(mask[..., 0][valid].any())
        assert int(lanes[..., 0].sum()) > 1000
    else:
        ulp = float(np.spacing(np.float32(1 / 255)))
        near = (alpha[valid] - 1 / 255).abs() <= 16 * ulp
        assert int((near & (alpha[valid] >= 1 / 255)).sum()) > 50
        assert int((near & (alpha[valid] < 1 / 255)).sum()) > 50


def test_sift_on_the_card_equals_the_cpu(dev):
    """SIFT keypoints on the card equal the CPU's (octave word equal, pt
    within 1e-3 px) with every descriptor entry within +-1, on >= 99% of the
    CPU's keypoints, and >= 95% of the CPU's cross-checked pairs are the
    card's, on a 640x480 high-contrast texture and a shifted copy."""
    from scipy import ndimage
    from scipy.spatial import cKDTree

    a = ndimage.gaussian_filter(np.random.default_rng(2).uniform(0, 1, (480, 640)), 1.5)
    img = ((a > np.median(a)) * 200 + 30).astype(np.uint8)
    images = (img, np.roll(img, (5, 9), axis=(0, 1)))
    kps, pairs = {}, {}
    for d in (torch.device("cpu"), dev):
        k = [sift.detect_and_compute(torch.as_tensor(g, device=d)) for g in images]
        q, t, _ = sift.cross_check_match(k[0]["desc"], k[1]["desc"])
        kps[d.type] = [{key: v.cpu().numpy() for key, v in kp.items()} for kp in k]
        pairs[d.type] = np.concatenate([k[0]["pt"][q].cpu().numpy(),
                                        k[1]["pt"][t].cpu().numpy()], 1)
    for cpu, card in zip(kps["cpu"], kps["cuda"]):
        assert abs(len(card["size"]) - len(cpu["size"])) <= 0.01 * len(cpu["size"])
        tree = cKDTree(card["pt"])
        ok = [any(card["octave"][j] == cpu["octave"][i]
                  and np.abs(card["desc"][j] - cpu["desc"][i]).max() <= 1
                  for j in tree.query_ball_point(p, 1e-3))
              for i, p in enumerate(cpu["pt"])]
        assert np.mean(ok) >= 0.99
    tree = cKDTree(pairs["cuda"])
    shared = [len(tree.query_ball_point(p, 2e-3)) > 0 for p in pairs["cpu"]]
    assert len(shared) > 100 and np.mean(shared) >= 0.95


def test_orb_on_the_card_equals_the_cpu(dev):
    """ORB keypoints (every field, in order), descriptors and cross-checked
    pairs on the card equal the CPU's, on a 640x480 high-contrast texture
    (every level's cap biting) and a shifted copy."""
    from scipy import ndimage

    from scorp_tpu_torch.pipeline import orb

    a = ndimage.gaussian_filter(np.random.default_rng(2).uniform(0, 1, (480, 640)), 1.5)
    img = ((a > np.median(a)) * 200 + 30).astype(np.uint8)
    images = (img, np.roll(img, (5, 9), axis=(0, 1)))
    out = {}
    for d in (torch.device("cpu"), dev):
        k = [orb.detect_and_compute(torch.as_tensor(g, device=d)) for g in images]
        out[d.type] = (k, orb.cross_check_match_hamming(k[0]["desc"], k[1]["desc"]))
    (k_cpu, p_cpu), (k_card, p_card) = out["cpu"], out["cuda"]
    for cpu, card in zip(k_cpu, k_card):
        assert len(cpu["size"]) >= 4096  # ties at the boundary response are kept
        for key in cpu:
            assert torch.equal(card[key].cpu(), cpu[key]), key
    assert len(p_cpu[0]) > 100
    for a, b in zip(p_card, p_cpu):
        assert torch.equal(a.cpu(), b)
