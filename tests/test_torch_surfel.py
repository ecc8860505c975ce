"""Port parity, the 2DGS surfel rasterizer: scorp_tpu_torch's
preprocess_surfel, surfel_adj, cull ellipses, K1's union cull, the plain
K4/K5/K6 versions and the differentiable `rasterize_surfel` (all on the
CPU) against scorp_tpu's `rasterize_surfel_xla` and
`rasterize_surfel_pallas` (Pallas kernels in interpret mode) on the same
numpy inputs, plus the analytic plane cases of tests/test_surfel.py and a
float64 brute force of the cull."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.ops.raster.pallas_surfel_train import rasterize_surfel_pallas
from scorp_tpu.ops.raster.surfel import depth_to_normal_jax, preprocess_surfel as j_prep
from scorp_tpu.ops.raster.surfel import rasterize_surfel_xla, surfel_adj as j_adj
from scorp_tpu.ops.raster.surfel import surfel_cull_ellipses as j_cull
from scorp_tpu_torch.ops.raster import RasterConfig, rasterize_surfel
from scorp_tpu_torch.ops.raster import common as tc
from scorp_tpu_torch.ops.raster import surfel as ts
from scorp_tpu_torch.ops.raster.expand import expand_inputs, expand_keys_plain
from scorp_tpu_torch.ops.raster.surfel_backward import surfel_backward, surfel_backward_plain
from scorp_tpu_torch.ops.raster.surfel_composite import (
    surfel_composite,
    surfel_composite_plain,
    surfel_composite_train,
)
from tests import test_pallas
from tests.test_pallas import CFG as JCFG
from tests.test_raster import CAM
from tests.test_surfel import CAM as PLANE_CAM
from tests.test_surfel import flat_surfel
from tests.test_torch_raster import port_camera, t

torch.set_num_threads(1)

W, H = CAM.width, CAM.height
TILES_X = tc.grid_dims(W, H)[0]
TCFG = RasterConfig(max_keys=1 << 14)
CHANNELS = ["color", "alpha", "depth_accum", "normal", "depth_median", "distortion"]
PARAMS = ["xyz", "scales", "quats", "opa", "colors"]
BG = np.array([0.1, 0.2, 0.3], np.float32)


def scene(n=60, seed=13):
    """TestPallasSurfelTrain's scene (xyz, scales [n, 2], quats, opa, colors)."""
    return [np.asarray(a) for a in test_pallas.TestPallasSurfelTrain._scene(None, n=n, seed=seed)]


def both_preps(arrays, **kw):
    xyz, scales, quats, opa, colors = arrays
    pj = j_prep(jnp.asarray(xyz), jnp.asarray(opa), CAM, colors_precomp=jnp.asarray(colors),
                scales=jnp.asarray(scales), quats=jnp.asarray(quats),
                **{k: jnp.asarray(v) for k, v in kw.items()})
    pt = ts.preprocess_surfel(t(xyz), t(opa), port_camera(), colors_precomp=t(colors),
                              scales=t(scales), quats=t(quats),
                              **{k: torch.as_tensor(v) for k, v in kw.items()})
    return pj, pt


@pytest.mark.parametrize("extra", ["plain", "deltas_alive"])
def test_preprocess_adj_and_cull_ellipses_match_jax(extra):
    arrays = scene(n=70, seed=9)
    kw = {}
    if extra == "deltas_alive":
        rng = np.random.default_rng(2)
        kw = dict(screen_deltas=rng.normal(0, 0.01, (70, 2)).astype(np.float32),
                  alive=rng.uniform(size=70) < 0.8)
    pj, pt = both_preps(arrays, **kw)
    # integer outputs exact
    for name in ("radii", "rect", "valid"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    assert int(pt.valid.sum()) > 30
    for name in ("M", "zrow", "xy", "depth", "normal", "color", "opacity"):
        ref = np.asarray(getattr(pj, name))
        np.testing.assert_allclose(getattr(pt, name).numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=name)
    adj_ref = np.asarray(j_adj(pj.M))
    np.testing.assert_allclose(ts.surfel_adj(pt.M).numpy(), adj_ref, rtol=0, atol=1e-6)
    # cull ellipses: the circle, the conic's quadratic coefficients (A, B, C)
    # and its force-keep choice agree to f32 rounding. Its centre and
    # threshold come from completing the square, which amplifies float32
    # rounding up to ~2% of the threshold here; the port completes it in
    # float64, the JAX package in float32, so they are held by what they
    # decide, K1's kept keys.
    port, ref = ts.surfel_cull_ellipses(pt), [torch.tensor(np.asarray(e)) for e in j_cull(pj)]
    torch.testing.assert_close(port[1], ref[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(port[0][:, 2:5], ref[0][:, 2:5], rtol=1e-5, atol=1e-12)
    assert torch.equal(port[0][:, 5] == 1e30, ref[0][:, 5] == 1e30)
    keys = [expand_keys_plain(expand_inputs(pt, W, H, 1 << 14, True, *e))[0] for e in (port, ref)]
    kept = int((keys[1] != keys[1].max()).sum())
    assert kept > 100 and int((keys[0] != keys[1]).sum()) <= 0.005 * kept


_JAX: dict = {}


def _loss_weights(seed=3):
    """Cotangent-free loss: every differentiable channel, as train_2dgs uses them."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0, 1, (3, H, W)).astype(np.float32))


def _loss(out, tgt):
    return (((out.color - tgt) ** 2).mean() + 0.2 * (out.alpha ** 2).mean()
            + 0.1 * (out.depth_accum ** 2).mean() + 0.1 * ((out.normal - 0.1) ** 2).mean()
            + 0.05 * (out.depth_median ** 2).mean() + 0.5 * out.distortion.mean())


def _jax_ref(ref):
    """(outputs, gradients, loss) of one JAX rasterizer on `scene()`, from
    one forward and one backward pass; cached per reference."""
    if ref not in _JAX:
        xyz, scales, quats, opa, colors = (jnp.asarray(a) for a in scene())
        tgt = _loss_weights()
        raster = rasterize_surfel_xla if ref == "xla" else rasterize_surfel_pallas
        kw = {} if ref == "xla" else {"interpret": True}

        def f(xyz, scales, quats, opa, colors):
            out = raster(xyz, opa, CAM, jnp.asarray(BG), colors_precomp=colors, scales=scales,
                         quats=quats, cfg=JCFG, **kw)
            return _loss(out, tgt), out

        if ref == "xla":
            f = jax.jit(f)
        (loss, out), grads = jax.value_and_grad(f, argnums=tuple(range(5)), has_aux=True)(
            xyz, scales, quats, opa, colors)
        _JAX[ref] = ({c: np.asarray(getattr(out, c)) for c in CHANNELS + ["radii"]},
                     [np.asarray(g) for g in grads], float(loss))
    return _JAX[ref]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_plain_forward_matches_jax(ref):
    outs, _, _ = _jax_ref(ref)
    xyz, scales, quats, opa, colors = (t(a) for a in scene())
    out = rasterize_surfel(xyz, opa, port_camera(), t(BG), colors_precomp=colors,
                           scales=scales, quats=quats, cfg=TCFG)
    assert int(out.num_dropped_keys) == 0
    assert float(out.alpha.mean()) > 0.3
    # the test_pallas.py tolerance: every channel within 2e-5
    for name in CHANNELS:
        np.testing.assert_allclose(getattr(out, name).numpy(), outs[name], rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(), outs["radii"])


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_rasterize_surfel_gradients_match_jax(ref):
    outs, grads, loss_ref = _jax_ref(ref)
    xyz, scales, quats, opa, colors = (t(a).requires_grad_(True) for a in scene())
    out = rasterize_surfel(xyz, opa, port_camera(), t(BG), colors_precomp=colors,
                           scales=scales, quats=quats, cfg=TCFG)
    loss = _loss(out, t(_loss_weights()))
    assert float(loss.detach()) == pytest.approx(loss_ref, rel=1e-5)
    got = torch.autograd.grad(loss, [xyz, scales, quats, opa, colors])
    for a, b, name in zip(got, grads, PARAMS):
        # the test_pallas.py tolerance
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, atol=3e-5 * max(scale, 1.0) + 1e-9,
                                   rtol=2e-4, err_msg=name)
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0, name


def _stream(arrays, dtype=torch.float32):
    xyz, scales, quats, opa, colors = arrays
    prep = ts.preprocess_surfel(t(xyz), t(opa), port_camera(), colors_precomp=t(colors),
                                scales=t(scales), quats=t(quats))
    ell, circ = ts.surfel_cull_ellipses(prep)
    route = tc.route_stream(prep, W, H, TCFG, geo=ell, geo2=circ)
    return ts.surfel_table(prep).to(dtype), route


def _cotangents(n_tiles, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(n_tiles, c, 256)), dtype=dtype)
            for c in (3, 1, 1, 3, 1, 1)]


def test_train_compositor_adds_residuals_to_the_eval_outputs():
    table, route = _stream(scene())
    data = table[route.gid.long()].contiguous()
    bg = t(BG)
    ev = surfel_composite(data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X)
    tr = surfel_composite_train(data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X)
    for a, b in zip(ev, tr[:6]):
        assert torch.equal(a, b)
    n_contrib, n_med, wm, wm2, t_final = tr[6:]
    assert torch.equal(tr[1], 1.0 - t_final)
    assert bool((n_med <= n_contrib).all()) and int(n_med.max()) > 0
    assert bool(((n_med > 0) == (n_contrib > 0)).all())
    # distortion = A·D2 - D² in closed form (the pair sum telescopes)
    a_tot = tr[1]
    np.testing.assert_allclose(tr[5].numpy(), (a_tot * wm2 - wm * wm).numpy(), atol=2e-5)


@pytest.mark.parametrize("opaque", [False, True])
def test_plain_backward_matches_float64_autograd(opaque):
    """In float64, K6's plain version against autograd through K5's plain
    version, summed onto the table rows. The scenes' alphas stay below the
    0.99 clamp, where autograd's gradient (stopped by the clamp) and K6's
    (passed through it) agree."""
    arrays = scene()
    if opaque:
        arrays[3] = np.full_like(arrays[3], 0.97)   # pixels saturate and terminate
    table, route = _stream(arrays, torch.float64)
    bg = torch.tensor(BG, dtype=torch.float64)
    g = _cotangents(route.tile_start.shape[0], torch.float64)
    data = table[route.gid.long()].detach().requires_grad_(True)
    out = surfel_composite_plain(data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X,
                                 train=True)
    if opaque:
        assert int((out[10] < 1e-3).sum()) > 20  # some pixels stop at T < 1e-4 / 0.99
    loss = sum((o * gi).sum() for o, gi in zip(out[:6], g))
    (d_data,) = torch.autograd.grad(loss, data)
    ref = torch.zeros(table.shape[0], ts.SURFEL_COLS, dtype=torch.float64)
    ref.index_add_(0, route.gid.long(), d_data)
    res = [o.detach() for o in out[6:]]
    got = surfel_backward_plain(data.detach(), route.gid, route.tile_start, route.tile_count,
                                bg, *g, res[4], res[0], res[1], res[2], res[3], table.shape[0],
                                tiles_x=TILES_X)
    scale = ref.abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert bool(((got - ref).abs() <= 1e-9 * scale).all())


def test_backward_wrapper_on_cpu_is_the_plain_version():
    table, route = _stream(scene())
    data = table.detach()[route.gid.long()].contiguous()
    bg = t(BG)
    outs = surfel_composite_train(data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X)
    n_contrib, n_med, wm, wm2, t_final = outs[6:]
    args = (data, route.gid, route.tile_start, route.tile_count, bg,
            *_cotangents(route.tile_start.shape[0], torch.float32), t_final, n_contrib, n_med,
            wm, wm2, table.shape[0])
    assert torch.equal(surfel_backward(*args, tiles_x=TILES_X),
                       surfel_backward_plain(*args, tiles_x=TILES_X))


def test_edge_on_surfels_give_finite_gradients():
    """Surfels seen exactly edge-on (the view ray in the splat's plane): the
    s_z clamp and the u/v clip keep the VJP finite (no inf·0)."""
    rng = np.random.default_rng(4)
    n = 24
    xyz = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # rotate the z axis onto x: normal along world x, so the camera on the
    # z axis sees the discs edge-on
    q = np.tile(np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0], np.float32), (n, 1))
    args = [t(xyz), t(np.full((n, 2), 0.3, np.float32)), t(q), t(np.full(n, 0.9, np.float32)),
            t(rng.uniform(0, 1, (n, 3)).astype(np.float32))]
    xyz_t, scales, quats, opa, colors = (a.requires_grad_(True) for a in args)
    out = rasterize_surfel(xyz_t, opa, port_camera(), t(BG), colors_precomp=colors,
                           scales=scales, quats=quats, cfg=TCFG)
    grads = torch.autograd.grad(_loss(out, t(_loss_weights())), [xyz_t, scales, quats, opa,
                                                                 colors])
    for g, name in zip(grads, PARAMS):
        assert bool(torch.isfinite(g).all()), name


# --- analytic planes (tests/test_surfel.py) --------------------------------

def _plane_render(g):
    cam = port_camera(PLANE_CAM)
    return rasterize_surfel(*(t(g[k]) for k in ("means3d", "opacities")), cam,
                            torch.zeros(3), colors_precomp=t(g["colors_precomp"]),
                            scales=t(g["scales"]), quats=t(g["quats"]),
                            cfg=RasterConfig(max_keys=1 << 13))


def test_flat_plane_depth_exact():
    out = _plane_render(flat_surfel())
    alpha_c = float(out.alpha[0, 32, 32])
    assert abs(alpha_c - 0.95) < 0.01  # the ray hits the splat center: G = 1
    assert abs(float(out.depth_accum[0, 32, 32]) / alpha_c - 2.0) < 1e-4
    assert abs(float(out.depth_median[0, 32, 32]) - 2.0) < 1e-4
    np.testing.assert_allclose(out.normal[:, 32, 32].numpy() / alpha_c, [0, 0, -1], atol=1e-4)
    # one contributor: no pairwise depth spread
    assert float(out.distortion.abs().max()) < 1e-6


def test_tilted_plane_depth_analytic():
    ang = np.pi / 6
    g = dict(means3d=np.zeros((1, 3), np.float32), opacities=np.array([0.99], np.float32),
             colors_precomp=np.ones((1, 3), np.float32), scales=np.full((1, 2), 2.0, np.float32),
             quats=np.array([[np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0]], np.float32))
    out = _plane_render(g)
    fx = 64 / (2 * float(PLANE_CAM.tanfovx))
    n_world = np.array([np.sin(ang), 0.0, np.cos(ang)])
    checked = 0
    for px in (20, 32, 44):
        a = float(out.alpha[0, 32, px])
        if a < 1e-3:
            continue
        d_meas = float(out.depth_accum[0, 32, px]) / a
        dirv = np.array([-(px - 31.5) / fx, 0.0, 1.0])
        d_true = np.dot(n_world, np.array([0, 0, 2.0])) / np.dot(n_world, dirv)
        assert abs(d_meas - d_true) < 2e-3, (px, d_meas, d_true)
        checked += 1
    assert checked == 3


def test_distortion_positive_two_layers():
    g = dict(means3d=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32),
             opacities=np.array([0.5, 0.9], np.float32), colors_precomp=np.ones((2, 3), np.float32),
             scales=np.full((2, 2), 0.5, np.float32),
             quats=np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (2, 1)))
    out = _plane_render(g)
    assert float(out.distortion[0, 32, 32]) > 1e-5


def test_depth_to_normal_matches_jax():
    rng = np.random.default_rng(5)
    depth = (2.0 + 0.3 * rng.uniform(size=(1, 64, 64))).astype(np.float32)
    ref = np.asarray(depth_to_normal_jax(PLANE_CAM, jnp.asarray(depth)))
    got = ts.depth_to_normal(port_camera(PLANE_CAM), t(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    flat = ts.depth_to_normal(port_camera(PLANE_CAM), torch.full((1, 64, 64), 2.0))
    inner = flat[:, 20:44, 20:44].numpy()
    np.testing.assert_allclose(np.linalg.norm(inner, axis=0), 1.0, atol=1e-4)
    assert np.all(np.abs(inner[2]) > 0.99)


# --- K1's union cull against a float64 brute force --------------------------

def test_union_cull_drops_no_contributing_key():
    """The port of tests/test_surfel.py's cull check: on large rotated
    anisotropic surfels, every key that K1's plain version culls with the
    surfel's two ellipses has alpha < 1/255 at every pixel of its tile, by
    the compositor's alpha formula in float64."""
    from scorp_tpu.core.camera import look_at_camera

    rng = np.random.default_rng(7)
    n, w, h = 160, 320, 240
    jcam = look_at_camera(eye=[0, 0, -3], target=[0, 0, 0], up=[0, 1, 0],
                          fovx=0.9, fovy=0.8, width=w, height=h)
    xyz = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    scales = np.stack([rng.uniform(0.02, 0.8, n), rng.uniform(0.005, 0.1, n)],
                      axis=1).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    opa = rng.uniform(0.05, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    prep = ts.preprocess_surfel(t(xyz), t(opa), port_camera(jcam), colors_precomp=t(colors),
                                scales=t(scales), quats=t(quats))
    ell, circ = ts.surfel_cull_ellipses(prep)
    k_cap = 1 << 15
    x0 = expand_inputs(prep, w, h, k_cap, cull=False)
    x1 = expand_inputs(prep, w, h, k_cap, cull=True, geo=ell, geo2=circ)
    assert int(x0.total) <= k_cap
    keys0, kept0 = expand_keys_plain(x0)
    keys1, kept1 = expand_keys_plain(x1)
    sentinel = x0.num_tiles << x0.bits_g
    culled = ((keys0 != sentinel) & (keys1 == sentinel)).numpy()
    assert int(kept1) < int(kept0)
    idx = np.nonzero(culled)[0]
    assert idx.size > 0

    keys0 = keys0.numpy()
    tile = keys0[idx] >> x0.bits_g
    gi = x0.order.numpy()[keys0[idx] & ((1 << x0.bits_g) - 1)]
    tiles_x = tc.grid_dims(w, h)[0]
    M = prep.M.numpy().astype(np.float64)
    xy = prep.xy.numpy().astype(np.float64)
    opa_p = prep.opacity.numpy().astype(np.float64)
    bad, worst = 0, 0.0
    for k in range(idx.size):
        g = gi[k]
        tx, ty = tile[k] % tiles_x, tile[k] // tiles_x
        PX, PY = np.meshgrid(np.arange(tx * 16, tx * 16 + 16, dtype=np.float64),
                             np.arange(ty * 16, ty * 16 + 16, dtype=np.float64))
        r1, r2, r3 = M[g]
        s = np.cross(r1[None, None] - PX[..., None] * r3[None, None],
                     r2[None, None] - PY[..., None] * r3[None, None])
        sz = np.where(np.abs(s[..., 2]) > 1e-9, s[..., 2], 1e-9)
        u = np.clip(s[..., 0] / sz, -1e3, 1e3)
        v = np.clip(s[..., 1] / sz, -1e3, 1e3)
        rho2d = ts.FILTER_INV_SQUARE * ((xy[g, 0] - PX) ** 2 + (xy[g, 1] - PY) ** 2)
        a = float(np.max(opa_p[g] * np.exp(-0.5 * np.minimum(u * u + v * v, rho2d))))
        worst = max(worst, a)
        bad += a >= ts.ALPHA_MIN
    assert bad == 0, (bad, worst)
