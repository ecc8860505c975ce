"""Port parity, rasterizer: scorp_tpu_torch's preprocess, expansion golden,
K1 and K2 plain versions and `rasterize`'s forward (all on the CPU) against
scorp_tpu's XLA golden paths and its Pallas kernels in interpret mode, on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.ops.raster import RasterConfig as JaxConfig
from scorp_tpu.ops.raster import rasterize_xla
from scorp_tpu.ops.raster import common as jc
from scorp_tpu.ops.raster.pallas_expand import expand_sorted_keys
from scorp_tpu.ops.raster.pallas_fwd import composite_stream_pallas, rasterize_pallas_fwd_only
from scorp_tpu_torch.core.camera import camera_from_numpy
from scorp_tpu_torch.ops.raster import RasterConfig, rasterize
from scorp_tpu_torch.ops.raster import common as tc
from scorp_tpu_torch.ops.raster.composite import composite, composite_plain
from scorp_tpu_torch.ops.raster.expand import expand_inputs, expand_keys, expand_keys_plain
from tests.test_pallas import make_saturating_scene
from tests.test_raster import BG, CAM, make_scene

torch.set_num_threads(1)

W, H = CAM.width, CAM.height
K_CAP = 1 << 14
JCFG = JaxConfig(max_keys=K_CAP, tile_list_len=256, chunk=16, pallas_chunk=128)
TCFG = RasterConfig(max_keys=K_CAP)
NUM_TILES = tc.grid_dims(W, H)[0] * tc.grid_dims(W, H)[1]


def port_camera(cam=CAM):
    return camera_from_numpy(
        np.asarray(cam.viewmatrix), np.asarray(cam.projmatrix),
        2 * np.arctan(float(cam.tanfovx)), 2 * np.arctan(float(cam.tanfovy)),
        cam.width, cam.height, np.asarray(cam.campos), device="cpu",
    )


def t(a):
    return torch.as_tensor(np.array(a))


def both_preps(scene, sh_degree=3, alive=None):
    xyz, scales, quats, opa, shs = scene
    pj = jc.preprocess(xyz, opa, CAM, shs=shs, sh_degree=sh_degree, scales=scales,
                       quats=quats, alive=None if alive is None else jnp.asarray(alive))
    pt = tc.preprocess_plain(t(xyz), t(opa), port_camera(), shs=t(shs), sh_degree=sh_degree,
                       scales=t(scales), quats=t(quats),
                       alive=None if alive is None else torch.as_tensor(alive))
    return pj, pt


@pytest.fixture(scope="module")
def preps():
    return both_preps(make_scene(n=200, seed=1))


@pytest.mark.parametrize("with_alive", [False, True])
def test_preprocess_matches_jax(with_alive):
    alive = None
    if with_alive:
        alive = np.random.default_rng(0).uniform(size=160) < 0.7
    pj, pt = both_preps(make_scene(n=160, seed=4), alive=alive)
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    np.testing.assert_array_equal(pt.rect.numpy(), np.asarray(pj.rect))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))
    for name in ("xy", "conic", "color", "depth", "opacity"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("cull", [False, True])
def test_expansion_golden_matches_jax(preps, cull):
    pj, pt = preps
    ref = jc._expand_keys_core(pj, W, H, K_CAP, cull=cull)
    got = tc._expand_keys_core(pt, W, H, K_CAP, cull=cull)
    for i, name in [(0, "tile"), (2, "order"), (6, "in_range")]:
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=name)
    assert int(got[3]) == int(ref[3]) and int(got[7]) == int(ref[7])


@pytest.mark.parametrize("k_cap", [K_CAP, 256])
def test_k1_plain_without_cull_equals_golden_tile_sort(preps, k_cap):
    pj, pt = preps
    tile, g_of_k, order, total, *_ = jc._expand_keys_core(pj, W, H, k_cap, cull=False)
    ref_tile, ref_g = jc._tile_sort(tile, g_of_k, NUM_TILES, pj.xy.shape[0])
    st, sg, t_order, t_total, kept = tc.sorted_expansion(pt, W, H, k_cap, cull=False)
    live = min(int(total), k_cap)
    assert int(t_total) == int(total) and int(kept) == live
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(st[:live].numpy(), np.asarray(ref_tile)[:live])
    np.testing.assert_array_equal(sg[:live].numpy(), np.asarray(ref_g)[:live])
    assert (st[live:] == NUM_TILES).all()
    dropped = max(int(total) - k_cap, 0)
    assert (dropped > 0) == (k_cap == 256)
    bins = tc.bin_stream(pt, W, H, RasterConfig(max_keys=k_cap))
    assert int(bins.num_dropped_keys) >= dropped


def _live_pairs(tile, g):
    m = tile < NUM_TILES
    return set(zip(tile[m].tolist(), g[m].tolist()))


def test_k1_plain_cull_is_subset_of_golden(preps):
    pj, pt = preps
    tile, g_of_k, _, _, _, _, _, kept_g = jc._expand_keys_core(pj, W, H, K_CAP, cull=True)
    ref_tile, ref_g = jc._tile_sort(tile, g_of_k, NUM_TILES, pj.xy.shape[0])
    st, sg, _, _, kept = tc.sorted_expansion(pt, W, H, K_CAP, cull=True)
    kept, kept_g = int(kept), int(kept_g)
    got = _live_pairs(st.numpy(), sg.numpy())
    assert len(got) == kept
    assert got <= _live_pairs(np.asarray(ref_tile), np.asarray(ref_g))
    assert 0.8 * kept_g <= kept <= kept_g + 1000


def test_k1_plain_matches_pallas_kernel(preps):
    pj, pt = preps
    packed, _, _, kept_j, bits_j, _ = expand_sorted_keys(pj, W, H, K_CAP, cull=True,
                                                          interpret=True)
    packed = np.asarray(packed)
    ref = _live_pairs(packed >> bits_j, packed & ((1 << bits_j) - 1))
    st, sg, _, _, kept = tc.sorted_expansion(pt, W, H, K_CAP, cull=True)
    got = _live_pairs(st.numpy(), sg.numpy())
    # borderline keys only: the Pallas kernel gathers the cull geometry by a
    # bf16x2 one-hot matmul (~2^-17 relative), the port reads it in f32
    assert len(got ^ ref) <= 0.005 * len(ref)
    assert abs(int(kept) - int(kept_j)) <= 0.005 * int(kept_j)


def test_k1_wrapper_on_cpu_is_the_plain_version(preps):
    _, pt = preps
    x = expand_inputs(pt, W, H, K_CAP, cull=True)
    for a, b in zip(expand_keys(x), expand_keys_plain(x)):
        assert torch.equal(a, b)


def _jax_stream(scene, sh_degree):
    xyz, scales, quats, opa, shs = scene
    pj = jc.preprocess(xyz, opa, CAM, shs=shs, sh_degree=sh_degree, scales=scales, quats=quats)
    bins = jc.bin_stream(pj, W, H, JCFG, interpret=True)
    k = int(bins.tile_start[-1] + bins.tile_count[-1])
    data = torch.from_numpy(np.array(bins.data[: tc.DATA_ROWS, :k]).T.copy())
    return bins, data, t(bins.tile_start).to(torch.int32), t(bins.tile_count).to(torch.int32)


@pytest.mark.parametrize("scene", ["random", "saturating"])
def test_k2_plain_matches_pallas_kernel(scene):
    if scene == "random":
        sc, deg = make_scene(n=200, seed=2), 3
    else:
        sc, deg = make_saturating_scene(n=300), 0
    bins, data, start, count = _jax_stream(sc, deg)
    ref = composite_stream_pallas(bins, BG, W, H, JCFG, interpret=True, track_ncontrib=True)
    got = composite_plain(data, start, count, t(BG), tiles_x=tc.grid_dims(W, H)[0],
                          track_ncontrib=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=5e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=5e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    if scene == "saturating":
        assert float(got[2].mean()) > 0.99  # the pixels really terminate
    wrapped = composite(data, start, count, t(BG), tiles_x=tc.grid_dims(W, H)[0],
                        track_ncontrib=True)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [2, 6])
def test_rasterize_matches_pallas_and_xla(seed):
    xyz, scales, quats, opa, shs = make_scene(n=150, seed=seed)
    kw = dict(shs=shs, sh_degree=3, scales=scales, quats=quats, cfg=JCFG)
    out_p = rasterize_pallas_fwd_only(xyz, opa, CAM, BG, interpret=True, **kw)
    out_x = rasterize_xla(xyz, opa, CAM, BG, **kw)
    out_t = rasterize(t(xyz), t(opa), port_camera(), t(BG), shs=t(shs), sh_degree=3,
                      scales=t(scales), quats=t(quats), cfg=TCFG)
    for ref in (out_p, out_x):
        # the test_pallas.py tolerances
        np.testing.assert_allclose(out_t.color.numpy(), np.asarray(ref.color), atol=5e-5)
        np.testing.assert_allclose(out_t.alpha.numpy(), np.asarray(ref.alpha), atol=5e-5)
        np.testing.assert_allclose(out_t.depth_accum.numpy(), np.asarray(ref.depth_accum),
                                   atol=2e-4)
        np.testing.assert_array_equal(out_t.radii.numpy(), np.asarray(ref.radii))
    assert int(out_t.num_dropped_keys) == 0


def test_rasterize_empty_scene_is_background():
    xyz, scales, quats, opa, shs = make_scene(n=8)
    out = rasterize(t(xyz), torch.zeros(8), port_camera(), t(BG), shs=t(shs),
                    scales=t(scales), quats=t(quats), cfg=TCFG)
    expected = np.broadcast_to(np.asarray(BG)[:, None, None], (3, H, W))
    np.testing.assert_allclose(out.color.numpy(), expected, atol=1e-6)
    np.testing.assert_allclose(out.alpha.numpy(), 0.0, atol=1e-6)


def test_rasterize_is_forward_only(monkeypatch):
    """Without an input that requires grad, rasterize is the eval path:
    nothing is saved for autograd and the compositor tracks no n_contrib."""
    import scorp_tpu_torch.ops.raster as raster_pkg

    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return composite(*args, **kwargs)

    monkeypatch.setattr(raster_pkg, "composite", spy)
    saved = []
    xyz, scales, quats, opa, shs = make_scene(n=40, seed=3)
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        out = rasterize(t(xyz), t(opa), port_camera(), t(BG), shs=t(shs), sh_degree=3,
                        scales=t(scales), quats=t(quats), cfg=TCFG)
    assert saved == [] and out.color.grad_fn is None
    assert len(calls) == 1 and not calls[0].get("track_ncontrib", False)
    assert float(out.alpha.mean()) > 0.01


def test_rasterize_grad_path_yields_finite_gradients():
    xyz, scales, quats, opa, shs = (t(a).requires_grad_(True) for a in make_scene(n=40, seed=3))
    out = rasterize(xyz, opa, port_camera(), t(BG), shs=shs, sh_degree=3, scales=scales,
                    quats=quats, cfg=TCFG)
    assert out.color.grad_fn is not None
    grads = torch.autograd.grad(out.color.mean() + out.alpha.mean(), [xyz, scales, quats, opa, shs])
    for g in grads:
        assert bool(torch.isfinite(g).all())
    assert float(grads[0].abs().max()) > 0.0
