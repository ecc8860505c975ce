"""Port parity, the differentiable rasterizer: the backward compositor's
plain version (K3's CPU path) against torch autograd through the forward
compositor's plain version in float64, and the port's `rasterize`
gradients against `jax.grad` of scorp_tpu's `rasterize_pallas` (Pallas
kernels in interpret mode) and `rasterize_xla`, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.ops.raster import RasterConfig as JaxConfig
from scorp_tpu.ops.raster import rasterize_xla
from scorp_tpu.ops.raster.pallas import rasterize_pallas
from scorp_tpu_torch.ops.raster import RasterConfig, rasterize
from scorp_tpu_torch.ops.raster import common as tc
from scorp_tpu_torch.ops.raster.backward import composite_backward, composite_backward_plain
from scorp_tpu_torch.ops.raster.composite import composite_plain
from tests.test_pallas import make_saturating_scene
from tests.test_raster import BG, CAM, make_scene
from tests.test_torch_raster import port_camera, t

torch.set_num_threads(1)

W, H = CAM.width, CAM.height
TILES_X = tc.grid_dims(W, H)[0]
JCFG = JaxConfig(max_keys=1 << 14, tile_list_len=256, chunk=16, pallas_chunk=128)
TCFG = RasterConfig(max_keys=1 << 14)
PARAMS = ["xyz", "scales", "quats", "opa", "shs", "deltas"]
# both scenes at n=200, so the second one reuses the first one's compiles
SCENES = {
    "random": (lambda: make_scene(n=200, seed=5), 1),
    "saturating": (lambda: make_saturating_scene(n=200, seed=11), 0),
}


def _stream(scene):
    """The port's stream of a scene: per-gaussian table, routing, tiles."""
    sc, deg = SCENES[scene]
    xyz, scales, quats, opa, shs = sc()
    prep = tc.preprocess(t(xyz), t(opa), port_camera(), shs=t(shs), sh_degree=deg,
                         scales=t(scales), quats=t(quats))
    return tc.stream_table(prep), tc.route_stream(prep, W, H, TCFG)


def _cotangents(n_tiles, dtype):
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.normal(size=(n_tiles, c, 256)), dtype=dtype) for c in (3, 1, 1)]


def _autograd_reference(table, route, bg, g):
    """d_table by torch autograd through composite_plain in float64, and
    that forward's n_contrib and t_final."""
    data = table.double()[route.gid.long()].detach().requires_grad_(True)
    out = composite_plain(data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X,
                          track_ncontrib=True, with_t_final=True)
    loss = (out[0] * g[0]).sum() + (out[1] * g[1]).sum() + (out[2] * g[2]).sum()
    (d_data,) = torch.autograd.grad(loss, data)
    d_table = torch.zeros(table.shape[0], 10, dtype=torch.float64)
    d_table.index_add_(0, route.gid.long(), d_data)
    return d_table, data.detach(), out[3], out[4].detach(), out[2].detach()


@pytest.mark.parametrize("scene", ["random", "saturating"])
def test_plain_backward_matches_float64_autograd(scene):
    """Alphas of these scenes stay below the 0.99 clamp, where autograd's
    gradient (stopped by the clamp) and K3's (passed through it) agree."""
    table, route = _stream(scene)
    bg = torch.tensor([0.2, 0.3, 0.4], dtype=torch.float64)
    g = _cotangents(route.tile_start.shape[0], torch.float64)
    ref, data, n_contrib, t_final, _ = _autograd_reference(table, route, bg, g)
    got = composite_backward_plain(data, route.gid, route.tile_start, route.tile_count, bg,
                                   *g, t_final, n_contrib, table.shape[0], tiles_x=TILES_X)
    scale = ref.abs().amax(dim=0)
    assert bool((scale > 0).all())
    assert bool(((got - ref).abs() <= 1e-9 * scale).all())


def test_t_final_keeps_gradient_precision_at_saturation():
    """In float32 the walk from K2's t_final stays within 1e-5 of the
    float64 gradient on saturated pixels (T ~ 1e-4); starting from
    1 - alpha instead loses ~3e-8 absolute, i.e. ~3e-4 relative of T,
    which every rebuilt T_before inherits."""
    table, route = _stream("saturating")
    bg64 = torch.tensor([0.2, 0.3, 0.4], dtype=torch.float64)
    ref = _autograd_reference(table, route, bg64, _cotangents(route.tile_start.shape[0],
                                                              torch.float64))[0]
    data = table.detach()[route.gid.long()].contiguous()
    bg, g = bg64.float(), _cotangents(route.tile_start.shape[0], torch.float32)
    _, _, alpha, n_contrib, t_final = composite_plain(
        data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X, track_ncontrib=True,
        with_t_final=True)
    assert float(alpha.mean()) > 0.99
    errs = []
    for residual in (t_final, 1.0 - alpha):
        got = composite_backward_plain(data, route.gid, route.tile_start, route.tile_count,
                                       bg, *g, residual, n_contrib, table.shape[0],
                                       tiles_x=TILES_X)
        errs.append(float(((got.double() - ref).abs().amax(0) / ref.abs().amax(0)).max()))
    assert errs[0] <= 1e-5
    assert errs[1] > 10 * errs[0]


def test_backward_wrapper_on_cpu_is_the_plain_version():
    table, route = _stream("random")
    data = table.detach()[route.gid.long()].contiguous()
    bg = torch.tensor([0.2, 0.3, 0.4])
    _, _, _, n_contrib, t_final = composite_plain(
        data, route.tile_start, route.tile_count, bg, tiles_x=TILES_X, track_ncontrib=True,
        with_t_final=True)
    args = (data, route.gid, route.tile_start, route.tile_count, bg,
            *_cotangents(route.tile_start.shape[0], torch.float32), t_final, n_contrib,
            table.shape[0])
    assert torch.equal(composite_backward(*args, tiles_x=TILES_X),
                       composite_backward_plain(*args, tiles_x=TILES_X))


def _loss_terms(out, target):
    return (((out.color - target) ** 2).mean() + 0.1 * (out.alpha ** 2).mean()
            + 0.05 * (out.depth_accum ** 2).mean())


_JAX_GRADS: dict = {}


def _jax_grads(scene, ref):
    """jax.grad of the test_pallas.py loss; cached per (scene, reference)."""
    if (scene, ref) not in _JAX_GRADS:
        sc, deg = SCENES[scene]
        xyz, scales, quats, opa, shs = sc()
        target = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (3, H, W)), jnp.float32)
        raster = rasterize_xla if ref == "xla" else rasterize_pallas
        kw = {} if ref == "xla" else {"interpret": True}

        def loss(xyz, scales, quats, opa, shs, deltas):
            out = raster(xyz, opa, CAM, BG, shs=shs, sh_degree=deg, scales=scales,
                         quats=quats, screen_deltas=deltas, cfg=JCFG, **kw)
            return _loss_terms(out, target)

        fn = jax.grad(loss, argnums=tuple(range(6)))
        if ref == "xla":
            fn = jax.jit(fn)  # one compile; the interpret-mode kernels run eagerly faster
        args = (xyz, scales, quats, opa, shs, jnp.zeros((xyz.shape[0], 2), jnp.float32))
        _JAX_GRADS[scene, ref] = ([np.asarray(g) for g in fn(*args)], args, target, deg)
    return _JAX_GRADS[scene, ref]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("scene", ["random", "saturating"])
def test_rasterize_gradients_match_jax(scene, ref):
    grads, args, target, deg = _jax_grads(scene, ref)
    xyz, scales, quats, opa, shs, deltas = (t(a).requires_grad_(True) for a in args)
    out = rasterize(xyz, opa, port_camera(), t(BG), shs=shs, sh_degree=deg, scales=scales,
                    quats=quats, screen_deltas=deltas, cfg=TCFG)
    if scene == "saturating":
        assert float(out.alpha.detach().mean()) > 0.9  # the pixels really terminate
    got = torch.autograd.grad(_loss_terms(out, t(target)),
                              [xyz, scales, quats, opa, shs, deltas])
    for a, b, name in zip(got, grads, PARAMS):
        # the test_pallas.py tolerance
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5 * max(scale, 1.0) + 1e-9,
                                   rtol=0, err_msg=name)
    assert int(out.num_dropped_keys) == 0


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_bg_gradient_matches_jax(ref):
    xyz, scales, quats, opa, shs = make_scene(n=32, seed=7)
    raster = rasterize_xla if ref == "xla" else rasterize_pallas
    kw = {} if ref == "xla" else {"interpret": True}

    def f(bg):
        out = raster(xyz, opa, CAM, bg, shs=shs, sh_degree=0, scales=scales, quats=quats,
                     cfg=JCFG, **kw)
        return (out.color ** 2).mean()

    expect = np.asarray(jax.grad(f)(BG))
    bg = t(BG).requires_grad_(True)
    out = rasterize(t(xyz), t(opa), port_camera(), bg, shs=t(shs), sh_degree=0,
                    scales=t(scales), quats=t(quats), cfg=TCFG)
    (got,) = torch.autograd.grad((out.color ** 2).mean(), bg)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-6, rtol=0)
