"""Port parity, scale-out: scorp_tpu_torch.parallel (process groups, the
camera-batch data-parallel 3DGS and 2DGS steps, camera-parallel eval) on
the CPU against scorp_tpu.parallel, called unsharded, on
tests/test_parallel.py's scene carried across as numpy; and the same steps
on two gloo ranks in spawned processes against one process."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.core.plyio import GaussianData as JaxGaussianData
from scorp_tpu.core.sh import rgb_to_sh
from scorp_tpu.parallel import dp_render as j_dp_render
from scorp_tpu.parallel import dp_train_step as j_dp_step
from scorp_tpu.parallel import dp_train_step_2d as j_dp_step_2d
from scorp_tpu.parallel.train_dp import stack_cameras as j_stack
from scorp_tpu.train import OptParams
from scorp_tpu.train import state as jstate
from scorp_tpu.train.step2d import Opt2DParams
from scorp_tpu_torch import parallel
from scorp_tpu_torch.ops.raster import RasterConfig
from scorp_tpu_torch.parallel import dryrun
from tests.test_parallel import CFG, H, W, make_cams, make_state
from tests.test_torch_raster import port_camera
from tests.test_torch_train import KEYS, _jax_adam, _np, _port

torch.set_num_threads(1)

TCFG = RasterConfig(max_keys=CFG.max_keys)
BG = np.zeros(3, np.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _surfel_state():
    """tests/test_parallel.py's 2DGS scene: 48 surfels, random rotations."""
    rng = np.random.default_rng(3)
    n = 48
    g = JaxGaussianData(
        xyz=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        f_dc=rgb_to_sh(rng.uniform(0.2, 0.8, (n, 3))).reshape(n, 1, 3).astype(np.float32),
        f_rest=np.zeros((n, 15, 3), np.float32),
        opacity=np.full((n, 1), 1.2, np.float32),
        scaling=np.full((n, 2), np.log(0.14), np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
    )
    return jstate.from_gaussian_data(g, capacity=64)


def _inputs(b, seed):
    """B cameras of the orbit, seeded ground truths and depth maps."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (b, 3, H, W)).astype(np.float32)
    d_cam = rng.uniform(0.5, 5.0, (b, 1, H, W)).astype(np.float32)
    d_est = rng.uniform(0.5, 5.0, (b, 1, H, W)).astype(np.float32)
    return make_cams(b), gt, d_cam, d_est


# (surfel, opt, iteration): 3DGS with the depth and isotropic terms on
# (depth_from_iter 0); 2DGS with the normal, distortion, depth and
# depth-normal terms on (iteration 8100 > depth_from_iter + 1000)
CASES = {
    "3dgs": (False, OptParams(depth_from_iter=0), 10),
    "2dgs": (True, Opt2DParams(lambda_dist=10.0), 8100),
}
_JAX: dict = {}


def _jax_run(kind, b, depth=True):
    key = (kind, b, depth)
    if key not in _JAX:
        surfel, opt, it = CASES[kind]
        st = _surfel_state() if surfel else make_state()
        adam = _jax_adam(st)
        cams, gt, d_cam, d_est = _inputs(b, seed=b)
        step = j_dp_step_2d if surfel else j_dp_step
        extra = (jnp.asarray(d_cam), jnp.asarray(d_est)) if depth else ()
        out = step(st, jax.tree_util.tree_map(jnp.copy, adam), j_stack(cams), jnp.asarray(gt),
                   jnp.int32(it), jnp.asarray(BG), *extra, opt=opt, sh_degree=0, cfg=CFG,
                   width=W, height=H, has_depth_cam=depth, has_depth_est=depth)
        _JAX[key] = (st, adam, jax.device_get(out))
    return _JAX[key]


def _port_run(kind, b, depth=True, group=None):
    surfel, opt, it = CASES[kind]
    st, adam, _ = _jax_run(kind, b, depth)
    ts, tadam = _port(st, adam)
    cams, gt, d_cam, d_est = _inputs(b, seed=b)
    step = parallel.dp_train_step_2d if surfel else parallel.dp_train_step
    extra = (torch.from_numpy(d_cam), torch.from_numpy(d_est)) if depth else ()
    return step(ts, tadam, parallel.stack_cameras([port_camera(c) for c in cams]),
                torch.from_numpy(gt), it, torch.from_numpy(BG), *extra, opt=opt, sh_degree=0,
                cfg=TCFG, width=W, height=H, has_depth_cam=depth, has_depth_est=depth,
                group=group)


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_dp_train_step_matches_jax(kind, b):
    """The one-step tests' tolerances (tests/test_torch_train.py for 3DGS,
    tests/test_torch_train2d.py for 2DGS): gradients recovered from the
    first moments within gtol = 2e-5 (3e-5 and 2e-4 relative for surfels)
    x max(scale, 1), the moments at the 3DGS test's bounds, the
    screen-gradient sums at the gradient tolerance, the integer statistics
    exact and the parameters within 1e-5."""
    st, adam, (js, ja, jm) = _jax_run(kind, b)
    ts, ta, tm = _port_run(kind, b)
    surfel = kind == "2dgs"
    rel, gfrac = (2e-4, 3e-5) if surfel else (0.0, 2e-5)
    for name in ("loss", "l1"):
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-5, abs=1e-7), name
    np.testing.assert_array_equal(ts.max_radii2d.numpy(), np.asarray(js.max_radii2d))
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    assert float(np.asarray(js.denom).sum()) > 0
    for k in KEYS:
        m0 = np.asarray(adam.m[k], np.float64)
        g_ref = (np.asarray(ja.m[k], np.float64) - 0.9 * m0) / 0.1
        g_got = (ta.m[k].numpy().astype(np.float64) - 0.9 * m0) / 0.1
        scale = max(np.abs(g_ref).max(), 1e-8)
        gtol = gfrac * max(scale, 1.0)
        np.testing.assert_allclose(g_got, g_ref, rtol=rel, atol=gtol, err_msg=k)
        np.testing.assert_allclose(ta.m[k].numpy(), ja.m[k], rtol=max(rel, 1e-6),
                                   atol=0.1 * gtol, err_msg=k)
        np.testing.assert_allclose(ta.v[k].numpy(), ja.v[k], rtol=max(rel, 1e-6),
                                   atol=0.002 * scale * gtol, err_msg=k)
    accum = np.asarray(js.xyz_grad_accum)
    assert accum.max() > 0
    np.testing.assert_allclose(ts.xyz_grad_accum.numpy(), accum, rtol=rel,
                               atol=gfrac * max(np.abs(accum).max(), 1.0))
    for k in KEYS:
        np.testing.assert_allclose(ts.params[k].numpy(), js.params[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert ta.step == int(ja.step) == int(adam.step) + 1


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_depth_losses_wired(kind):
    """TestDpTrainStep.test_depth_losses_wired: with the depth maps the loss
    is larger, in the port as in JAX (the losses within 1e-5)."""
    _, _, (_, _, jm_plain) = _jax_run(kind, 4, depth=False)
    _, _, (_, _, jm_depth) = _jax_run(kind, 4, depth=True)
    plain = float(_port_run(kind, 4, depth=False)[2]["loss"])
    depth = float(_port_run(kind, 4, depth=True)[2]["loss"])
    assert plain == pytest.approx(float(jm_plain["loss"]), rel=1e-5)
    assert depth == pytest.approx(float(jm_depth["loss"]), rel=1e-5)
    assert depth > plain and float(jm_depth["loss"]) > float(jm_plain["loss"])


def test_densify_stats_match_single_camera_steps():
    """TestDpTrainStep.test_densify_stats_match_sequential_reference in the
    port: the B-camera statistics are the sums (max_radii2d the maximum) of
    the B one-camera dp steps' (each at B = 1: its own screen gradient)."""
    st = make_state(seed=3)
    ts = _port(st)
    cams, gt, _, _ = _inputs(4, seed=2)
    tcams = [port_camera(c) for c in cams]
    kw = dict(opt=OptParams(), sh_degree=0, cfg=TCFG, width=W, height=H)
    bg = torch.from_numpy(BG)
    full, _, _ = parallel.dp_train_step(ts, _init_adam(ts), parallel.stack_cameras(tcams),
                                        torch.from_numpy(gt), 1, bg, **kw)
    singles = [parallel.dp_train_step(ts, _init_adam(ts), parallel.stack_cameras([c]),
                                      torch.from_numpy(gt[i:i + 1]), 1, bg, **kw)[0]
               for i, c in enumerate(tcams)]
    np.testing.assert_allclose(full.xyz_grad_accum.numpy(),
                               sum(s.xyz_grad_accum.numpy() for s in singles), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(full.denom.numpy(), sum(s.denom.numpy() for s in singles))
    np.testing.assert_array_equal(full.max_radii2d.numpy(),
                                  np.max([s.max_radii2d.numpy() for s in singles], axis=0))


def _init_adam(ts):
    from scorp_tpu_torch.train import init_adam

    return init_adam(ts)


def test_dp_render_matches_jax_and_render():
    """dp_render against JAX's at 2e-5, and bit-equal to render() of each
    camera."""
    from scorp_tpu_torch.render import render

    st = make_state(seed=1)
    cams = make_cams(3)
    ref = jax.device_get(j_dp_render(st.params, st.alive, j_stack(cams), jnp.asarray(BG),
                                     sh_degree=0, cfg=CFG, width=W, height=H))
    ts = _port(st)
    tcams = [port_camera(c) for c in cams]
    got = parallel.dp_render(ts.params, ts.alive, parallel.stack_cameras(tcams),
                             torch.from_numpy(BG), sh_degree=0, cfg=TCFG, width=W, height=H)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-5)
    assert float(got[1].mean()) > 0.05
    for i, cam in enumerate(tcams):
        out = render(cam, ts, torch.from_numpy(BG), sh_degree=0, cfg=TCFG)
        assert torch.equal(got[0][i], out["render"])
        assert torch.equal(got[1][i], out["render_alpha"])
        assert torch.equal(got[2][i], out["render_depth"])


def test_one_rank_group_and_sharding():
    """A one-rank gloo group gives the no-group step bit for bit; shard_batch
    takes contiguous slices and refuses a batch that does not divide."""
    with parallel.make_group(1, 0, device="cpu", timeout=30) as group:
        assert group.world_size == 1 and group.store.port > 0
        ts, ta, tm = _port_run("3dgs", 2, group=group)
        x = torch.arange(6)
        assert torch.equal(parallel.shard_batch({"a": x}, group)["a"], x)
        assert parallel.replicate(x, group) is x
    ref = _port_run("3dgs", 2)
    for k in KEYS:
        assert torch.equal(ts.params[k], ref[0].params[k]), k
    assert float(tm["loss"]) == float(ref[2]["loss"])

    class _Rank:  # shard_batch reads only the rank and world size
        def __init__(self, rank, world):
            self.rank, self.world_size = rank, world

    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(parallel.shard_batch(x, _Rank(1, 3)), x[2:4])
    assert parallel.shard_batch((x,), _Rank(2, 3))[0].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch(x, _Rank(0, 4))
    with pytest.raises(ValueError, match="agreed port"):
        parallel.make_group(2, 0, device="cpu")


def test_make_group_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_group(1, 0)


def test_two_gloo_ranks_equal_one_process():
    """dp_train_step, dp_render and dp_train_step_2d on 2 gloo ranks in
    spawned processes (2 cameras each, a 60 s timeout each): every rank
    holds the same bits, equal to the one-process calls within 1e-6 (the
    gradients are summed in another order), frames and integer statistics
    exactly."""
    reference, ranks = dryrun.run(2, timeout=60.0)
    assert len(ranks) == 2
    dryrun.check(reference, ranks)
    assert reference["3d_denom"].sum() > 0 and reference["2d_denom"].sum() > 0
    start = dryrun._scene(4, surfel=False)[0].params["xyz"].numpy()
    assert np.abs(ranks[1]["3d_param_xyz"] - start).max() > 0  # the step moved them


def test_dryrun_module_prints_ok():
    r = subprocess.run([sys.executable, "-m", "scorp_tpu_torch.parallel.dryrun", "2"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].startswith("dryrun(2): ok, loss=")
