"""Port parity, training: scorp_tpu_torch.train (Adam, the learning-rate
schedule, capacity growth, initialisation, one train_step, densification)
and apps.train_3dgs on the CPU against scorp_tpu's from the same state,
carried across as numpy."""

import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scorp_tpu.apps import train_3dgs as japp
from scorp_tpu.ops.raster import RasterConfig as JaxConfig
from scorp_tpu.train import densify as jdensify
from scorp_tpu.train import state as jstate
from scorp_tpu.train import step as jstep
from scorp_tpu_torch.apps import train_3dgs as tapp
from scorp_tpu_torch.core.plyio import load_gaussian_ply
from scorp_tpu_torch.ops.raster import RasterConfig
from scorp_tpu_torch.train import densify as tdensify
from scorp_tpu_torch.train import state as tstate
from scorp_tpu_torch.train import step as tstep
from tests.synth import build_dataset
from tests.test_raster import BG, CAM, make_scene
from tests.test_torch_raster import port_camera, t

torch.set_num_threads(1)

KEYS = tstate.PARAM_KEYS


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _jax_state(n=200, seed=3, cap=None, dead_every=7):
    """A JAX GaussianState of make_scene with some dead rows and nonzero
    densification statistics."""
    xyz, scales, quats, opa, shs = (np.asarray(a) for a in make_scene(n=n, seed=seed))
    from scorp_tpu.core.plyio import GaussianData

    g = GaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                     opacity=np.log(opa / (1 - opa))[:, None].astype(np.float32),
                     scaling=np.log(scales), rotation=quats)
    st = jstate.from_gaussian_data(g, capacity=cap)
    rng = np.random.default_rng(seed)
    alive = np.asarray(st.alive).copy()
    alive[::dead_every] = False
    c = st.capacity
    denom = np.where(alive, rng.integers(0, 5, c), 0).astype(np.float32)
    accum = (denom * rng.uniform(0, 4e-4, c)).astype(np.float32)
    radii = np.where(alive, rng.integers(0, 9, c), 0).astype(np.float32)
    return st._replace(alive=jnp.asarray(alive), max_radii2d=jnp.asarray(radii),
                       xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom))


def _jax_adam(st, seed=4, step=6):
    rng = np.random.default_rng(seed)
    m = {k: jnp.asarray(rng.normal(0, 1e-3, v.shape).astype(np.float32))
         for k, v in st.params.items()}
    v = {k: jnp.asarray(rng.uniform(1e-7, 1e-5, v.shape).astype(np.float32))
         for k, v in st.params.items()}
    return jstate.AdamState(m, v, jnp.int32(step))


def _port(st, adam=None):
    ts = tstate.state_from_numpy(_np(st.params), np.asarray(st.alive), "cpu",
                                 np.asarray(st.max_radii2d), np.asarray(st.xyz_grad_accum),
                                 np.asarray(st.denom))
    if adam is None:
        return ts
    return ts, tstate.adam_from_numpy(_np(adam.m), _np(adam.v), int(adam.step), "cpu")


def _close(got: dict, ref: dict, **tol):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **tol)


@pytest.mark.parametrize("frozen", [(), ("xyz", "opacity")])
def test_adam_update_matches_jax(frozen):
    st = _jax_state()
    adam = _jax_adam(st)
    rng = np.random.default_rng(9)
    grads = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in st.params.items()}
    lrs = {"xyz": 1.6e-4, "f_dc": 0.0025, "f_rest": 0.000125, "opacity": 0.05,
           "scaling": 0.005, "rotation": 0.001}
    jp, ja = jstate.adam_update(st.params, {k: jnp.asarray(v) for k, v in grads.items()},
                                adam, lrs, frozen=frozen)
    ts, tadam = _port(st, adam)
    tp, ta = tstate.adam_update(ts.params, {k: torch.from_numpy(v) for k, v in grads.items()},
                                tadam, lrs, frozen=frozen)
    assert ta.step == int(ja.step) == 7
    # the same f32 operations in the same order; pow and the bias-corrected
    # division may round 1 ulp apart
    _close(ta.m, ja.m, rtol=1e-6, atol=1e-12)
    _close(ta.v, ja.v, rtol=1e-6, atol=1e-15)
    _close(tp, jp, rtol=1e-6, atol=1e-9)
    for k in frozen:
        assert torch.equal(tp[k], ts.params[k]) and torch.equal(ta.m[k], tadam.m[k])


@pytest.mark.parametrize("step", [0, 1, 250, 7000, 29_999, 40_000])
def test_expon_lr_matches_jax(step):
    for kw in ({}, {"lr_delay_steps": 500, "lr_delay_mult": 0.01}):
        ref = float(jstate.expon_lr(jnp.float32(step), 1.6e-4, 1.6e-6, 30_000, **kw))
        got = tstate.expon_lr(step, 1.6e-4, 1.6e-6, 30_000, **kw)
        assert got == pytest.approx(ref, rel=1e-6)  # f64 on the host vs f32 in JAX


def test_grow_capacity_matches_jax():
    st = _jax_state()
    adam = _jax_adam(st)
    js, ja = jstate.grow_capacity(st, adam, 8192)
    ts, ta = tstate.grow_capacity(*_port(st, adam), 8192)
    assert ts.capacity == js.capacity == 8192 and ta.step == int(ja.step)
    _close(ts.params, js.params, rtol=0, atol=0)
    _close(ta.m, ja.m, rtol=0, atol=0)
    _close(ta.v, ja.v, rtol=0, atol=0)
    for name in ("alive", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))


@pytest.mark.parametrize("surfel", [False, True])
def test_from_point_cloud_and_to_gaussian_data_match_jax(surfel):
    rng = np.random.default_rng(2)
    # 1/64-grid points: KNN distances are exact in both packages
    pts = (rng.integers(-64, 65, (300, 3)) / 64.0).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    js = jstate.from_point_cloud(pts, cols, max_sh_degree=3, surfel=surfel)
    ts = tstate.from_point_cloud(pts, cols, max_sh_degree=3, surfel=surfel, device="cpu")
    assert ts.capacity == js.capacity
    _close(ts.params, js.params, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    jg, tg = jstate.to_gaussian_data(js), tstate.to_gaussian_data(ts)
    for k in KEYS:
        np.testing.assert_allclose(getattr(tg, k), getattr(jg, k), rtol=1e-6, atol=0)
    assert tg.n == 300


def _gt_maps(seed):
    rng = np.random.default_rng(seed)
    h, w = CAM.height, CAM.width
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    dcam = rng.uniform(0.2, 8.0, (1, h, w)).astype(np.float32)
    dest = np.where(rng.uniform(size=(1, h, w)) < 0.8,
                    rng.uniform(1, 6, (1, h, w)), 0).astype(np.float32)
    return img, dcam, dest


_JAX_STEPS: dict = {}


def _jax_step(iteration):
    """JAX train_step from _jax_state/_jax_adam (one compile for both
    iterations: the iteration is traced, the depth flags are static)."""
    if iteration not in _JAX_STEPS:
        st, img = _jax_state(), _gt_maps(0)
        adam = _jax_adam(st)
        out = jstep.train_step(
            st, jax.tree_util.tree_map(jnp.copy, adam), CAM, *map(jnp.asarray, img),
            jnp.int32(iteration), BG, opt=jstep.OptParams(),
            sh_degree=3, cfg=JaxConfig(max_keys=1 << 14, tile_list_len=256, chunk=16),
            has_depth_cam=True, has_depth_est=True)
        _JAX_STEPS[iteration] = (st, adam, img, jax.device_get(out))
    return _JAX_STEPS[iteration]


@pytest.mark.parametrize("iteration", [120, 7100])  # before / after depth_from_iter
def test_train_step_matches_jax(iteration):
    st, adam, img, (js, ja, jm) = _jax_step(iteration)
    ts, tadam = _port(st, adam)
    ts2, ta2, tm = tstep.train_step(
        ts, tadam, port_camera(), *map(torch.from_numpy, img), iteration, t(BG),
        opt=tstep.OptParams(), sh_degree=3, cfg=RasterConfig(max_keys=1 << 14),
        has_depth_cam=True, has_depth_est=True)
    assert (float(jm.depth_loss) > 0) == (iteration > 7000)
    for name in ("loss", "l1", "depth_loss", "psnr"):
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-5,
                                                         abs=1e-7), name
    assert int(tm.num_dropped_keys) == int(jm.num_dropped_keys) == 0
    assert int(tm.num_alive) == int(jm.num_alive)
    # integer statistics: exact
    np.testing.assert_array_equal(ts2.max_radii2d.numpy(), np.asarray(js.max_radii2d))
    np.testing.assert_array_equal(ts2.denom.numpy(), np.asarray(js.denom))
    # the gradients, recovered from the first moments: m' = 0.9 m + 0.1 g,
    # held at the rasterizer-gradient tolerance gtol = 2e-5 max(scale, 1)
    # (the recovery itself adds ~1e-6 relative: m' and 0.9 m cancel). The
    # moments then differ by 0.1 gtol (m) and 0.001 x 2 |g| gtol (v), plus
    # f32 rounding.
    for k in KEYS:
        m0 = np.asarray(adam.m[k], np.float64)
        g_ref = (np.asarray(ja.m[k], np.float64) - 0.9 * m0) / 0.1
        g_got = (ta2.m[k].numpy().astype(np.float64) - 0.9 * m0) / 0.1
        scale = max(np.abs(g_ref).max(), 1e-8)
        gtol = 2e-5 * max(scale, 1.0)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=gtol, err_msg=k)
        np.testing.assert_allclose(ta2.m[k].numpy(), ja.m[k], rtol=1e-6, atol=0.1 * gtol,
                                   err_msg=k)
        np.testing.assert_allclose(ta2.v[k].numpy(), ja.v[k], rtol=1e-6,
                                   atol=0.002 * scale * gtol, err_msg=k)
        dead = ~np.asarray(st.alive)  # the dead-row select: g = 0 exactly there
        np.testing.assert_array_equal(ta2.m[k].numpy()[dead], np.asarray(ja.m[k])[dead])
    # xyz_grad_accum adds |screen-delta gradient|: the gradient tolerance
    accum = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(ts2.xyz_grad_accum.numpy(), accum, rtol=0,
                               atol=2e-5 * max(np.abs(accum).max(), 1.0))
    # parameters move by lr x m/sqrt(v) with v >= 1e-7 here: a moment
    # difference of 0.1 gtol moves them by at most ~lr x 0.1 gtol / 3e-4
    _close(ts2.params, js.params, rtol=0, atol=1e-5)
    assert ta2.step == int(ja.step) == int(adam.step) + 1


def test_train_step_skips_adam_on_the_final_iteration():
    st = _jax_state(n=40)
    ts, tadam = _port(st, _jax_adam(st))
    img = _gt_maps(1)
    ts2, ta2, _ = tstep.train_step(
        ts, tadam, port_camera(), *map(torch.from_numpy, img), 30, t(BG),
        opt=tstep.OptParams(iterations=30), sh_degree=0, cfg=RasterConfig(max_keys=1 << 14))
    assert ta2.step == tadam.step
    for k in KEYS:
        assert torch.equal(ts2.params[k], ts.params[k])
    assert float(ts2.denom.sum()) > float(ts.denom.sum())  # statistics still accumulate


def _jax_noise(key, cap, n_split=2):
    keys = jax.random.split(key, n_split)
    return [np.asarray(jax.random.normal(keys[j], (cap, 3), jnp.float32))
            for j in range(n_split)]


@pytest.mark.parametrize("case", ["roomy", "size_threshold", "full"])
def test_densify_and_prune_matches_jax(case):
    cap = 256 if case == "full" else None  # 'full': few free slots, candidates drop
    st = _jax_state(n=230 if case == "full" else 200, cap=cap)
    adam = _jax_adam(st)
    key = jax.random.PRNGKey(3)
    kw = dict(max_screen_size=0.5, use_size_threshold=case == "size_threshold")
    args = (2e-4, 0.3, 2.0, 0.02)  # max_grad, min_opacity, extent, percent_dense
    js, ja, jdrop = jdensify.densify_and_prune(st, adam, key, *args, **kw)
    ts, ta, tdrop = tdensify.densify_and_prune(
        *_port(st, adam), [torch.tensor(a) for a in _jax_noise(key, st.capacity)],
        *args, **kw)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(tdrop) == int(jdrop)
    assert (int(jdrop) > 0) == (case == "full")
    _close(ts.params, js.params, rtol=1e-6, atol=1e-6)
    _close(ta.m, ja.m, rtol=0, atol=0)
    _close(ta.v, ja.v, rtol=0, atol=0)
    assert float(ts.denom.abs().sum() + ts.xyz_grad_accum.abs().sum()) == 0.0
    n_before, n_after = int(np.asarray(st.alive).sum()), int(ts.alive.sum())
    assert n_after != n_before  # something was cloned, split or pruned


def test_densify_with_a_generator_is_seeded():
    st = _jax_state()
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(tdensify.densify_and_prune(*_port(st, _jax_adam(st)), gen,
                                               2e-4, 0.3, 2.0, 0.02)[0])
    assert torch.equal(outs[0].params["xyz"], outs[1].params["xyz"])


def test_reset_opacity_stats_and_candidates_match_jax():
    st = _jax_state()
    adam = _jax_adam(st)
    js, ja = jdensify.reset_opacity(st, adam, 16)
    ts, ta = tdensify.reset_opacity(*_port(st, adam), 16)
    _close(ts.params, js.params, rtol=1e-6, atol=1e-6)
    _close(ta.m, ja.m, rtol=0, atol=0)
    assert int(tdensify.count_densify_candidates(_port(st), 2e-4)) == int(
        jdensify.count_densify_candidates(st, 2e-4))
    rng = np.random.default_rng(8)
    grad = rng.normal(0, 1e-3, (st.capacity, 2)).astype(np.float32)
    radii = rng.integers(0, 4, st.capacity).astype(np.int32)
    jacc = jdensify.accumulate_stats(st, jnp.asarray(grad), jnp.asarray(radii))
    tacc = tdensify.accumulate_stats(_port(st), torch.from_numpy(grad), torch.from_numpy(radii))
    for name in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(tacc, name).numpy(), np.asarray(getattr(jacc, name)))
    np.testing.assert_allclose(tacc.xyz_grad_accum.numpy(), np.asarray(jacc.xyz_grad_accum),
                               rtol=1e-6, atol=0)


def test_opacity_tracker_matches_jax():
    st = _jax_state()
    adam = _jax_adam(st)
    jt, tt = jdensify.OpacityTracker(st.capacity), tdensify.OpacityTracker(st.capacity,
                                                                         device="cpu")
    js, ts = st, _port(st, adam)
    for _ in range(4):  # one full bank epoch and the start of the next
        js, _ = jt.reset(js, adam)
        ts = tt.reset(*ts)
        _close(ts[0].params, js.params, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tt.always_high.numpy(), np.asarray(jt.always_high))


# --- the app ---------------------------------------------------------------

SYNTH_W, SYNTH_H = 48, 36


@pytest.fixture(scope="module")
def synth_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    scene = str(root / "scene")
    build_dataset(scene, n_views=4, width=SYNTH_W, height=SYNTH_H, n_gauss=48)
    return root, scene


def _argv(scene, model, *extra):
    return ["-s", scene, "-m", model, "--quiet", "--test_iterations", "-1", *extra]


def test_app_trains_densifies_and_writes_the_ply(synth_scene):
    root, scene = synth_scene
    model = str(root / "torch_densify")
    # opacity_cull 0.005 (the original 3DGS value): this repo's 0.6 would
    # prune every initial point (opacity 0.1) at the first densification
    _, state, adam, log = tapp.main(_argv(
        scene, model, "--iterations", "12", "--densify_from_iter", "5",
        "--densification_interval", "10", "--densify_until_iter", "11", "--opacity_cull",
        "0.005", "--test_iterations", "12", "--device", "cpu"))
    assert len(log["loss"]) == 12 and all(np.isfinite(log["loss"]))
    assert log["dropped_keys"] == [0] * 12
    ply = os.path.join(model, "point_cloud", "iteration_12", "point_cloud.ply")
    g = load_gaussian_ply(ply, max_sh_degree=3)
    assert g.n == int(state.num_alive()) > 0
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
    assert adam.step == 11  # no Adam step on the final iteration


def test_app_matches_jax_app_and_resumes_its_checkpoint(synth_scene):
    root, scene = synth_scene
    ckpt = {}
    for name, app, extra in (("jax", japp, []), ("torch", tapp, ["--device", "cpu"])):
        model = str(root / f"{name}_5")
        app.main(_argv(scene, model, "--iterations", "5", "--densify_until_iter", "0",
                       "--checkpoint_iterations", "5", *extra))
        time.sleep(1.2)  # the JAX app's prefetch thread leaves within a second
        with open(os.path.join(model, "chkpnt5.pth"), "rb") as f:
            ckpt[name] = pickle.load(f)
    j, p = ckpt["jax"], ckpt["torch"]
    assert sorted(p) == sorted(j) and p["iteration"] == j["iteration"] == 5
    assert p["adam_step"] == j["adam_step"] == 4
    np.testing.assert_array_equal(p["alive"], j["alive"])
    # four Adam steps from zero moments: the first is lr x sign(g), so a
    # gradient that is ~0 in both packages may take opposite signs; the
    # rest moves by lr x (a ratio of moments that agree to ~1e-5)
    for k in KEYS:
        np.testing.assert_allclose(p["params"][k], j["params"][k], rtol=0, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(p["adam_m"][k], j["adam_m"][k], rtol=0,
                                   atol=1e-5 * max(np.abs(j["adam_m"][k]).max(), 1e-3),
                                   err_msg=k)
    # the port resumes the JAX checkpoint and trains on
    model = str(root / "resumed")
    _, state, adam, log = tapp.main(_argv(
        scene, model, "--iterations", "7", "--densify_until_iter", "0", "--start_checkpoint",
        os.path.join(str(root / "jax_5"), "chkpnt5.pth"), "--device", "cpu"))
    assert len(log["loss"]) == 2 and adam.step == 5


def test_training_raises_without_gpu(synth_scene, monkeypatch):
    root, scene = synth_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(_argv(scene, str(root / "nogpu")))
    st = _jax_state(n=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.state_from_numpy(_np(st.params), np.asarray(st.alive))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.from_point_cloud(np.zeros((5, 3), np.float32), np.zeros((5, 3), np.float32))
    # train_step runs on its camera's device: a cuda camera cannot be made
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstate.camera_from_numpy(np.asarray(CAM.viewmatrix), np.asarray(CAM.projmatrix), 0.8,
                                 0.8, CAM.width, CAM.height, np.asarray(CAM.campos))
    # --gui with no viewer attached (on a port the OS picks) trains to the
    # end, and --profile writes a torch.profiler trace
    trace = root / "trace"
    _, _, adam, log = tapp.main(_argv(scene, str(root / "gui"), "--gui", "--port", "0",
                                      f"--profile={trace}", "--iterations", "3",
                                      "--densify_until_iter", "0", "--device", "cpu"))
    assert len(log["loss"]) == 3 and adam.step == 2
    assert (trace / "train_3dgs.pt.trace.json").stat().st_size > 0
