"""Port parity, 2DGS: scorp_tpu_torch's render2d, one train_step_2d (normal
and distortion losses on) and apps.render_2dgs / apps.train_2dgs on the CPU
against scorp_tpu's from the same state, carried across as numpy."""

import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scorp_tpu.apps import train_2dgs as japp
from scorp_tpu.core.plyio import GaussianData as JaxGaussianData
from scorp_tpu.ops.raster import RasterConfig as JaxConfig
from scorp_tpu.render2d import render2d as j_render2d
from scorp_tpu.train import state as jstate
from scorp_tpu.train import step2d as jstep2d
from scorp_tpu_torch.apps import render_2dgs as trender_app
from scorp_tpu_torch.apps import train_2dgs as tapp
from scorp_tpu_torch.core.plyio import load_gaussian_ply, save_gaussian_ply
from scorp_tpu_torch.ops.raster import RasterConfig
from scorp_tpu_torch.render2d import render2d
from scorp_tpu_torch.train import state as tstate
from scorp_tpu_torch.train import step2d as tstep2d
from tests.synth import build_dataset
from tests.test_raster import BG, CAM, make_scene
from tests.test_torch_raster import port_camera, t
from tests.test_torch_train import KEYS, _close, _gt_maps, _jax_adam, _np, _port

torch.set_num_threads(1)

JCFG = JaxConfig(max_keys=1 << 14, tile_list_len=256, chunk=16)
TCFG = RasterConfig(max_keys=1 << 14)


def _surfel_data(n=200, seed=3):
    """make_scene's gaussians as surfels: its first two scales, SH 3."""
    xyz, scales, quats, opa, shs = (np.asarray(a) for a in make_scene(n=n, seed=seed, scale=0.08))
    return JaxGaussianData(xyz=xyz, f_dc=shs[:, :1], f_rest=shs[:, 1:],
                           opacity=np.log(opa / (1 - opa))[:, None].astype(np.float32),
                           scaling=np.log(scales[:, :2]), rotation=quats)


def _jax_state2d(dead_every=7):
    st = jstate.from_gaussian_data(_surfel_data())
    alive = np.asarray(st.alive).copy()
    alive[::dead_every] = False
    return st._replace(alive=jnp.asarray(alive))


def test_render2d_matches_jax():
    st = _jax_state2d()
    ref = jax.device_get(j_render2d(CAM, st, BG, cfg=JCFG, depth_ratio=0.5))
    got = render2d(port_camera(), _port(st), t(BG), cfg=TCFG, depth_ratio=0.5)
    # every key of the JAX dict but `num_dropped_tail`, what its XLA path's
    # per-tile lists cut: the port has no such lists
    assert sorted(got) == sorted(set(ref) - {"num_dropped_tail"})
    assert int(got["num_dropped_keys"]) == int(ref["num_dropped_keys"]) == 0
    assert float(got["render_alpha"].mean()) > 0.2
    for name in ("radii", "visibility_filter"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)
    # the allmap channels at the rasterizer tolerance (2e-5); render_depth is
    # a depth (~4 here) divided by alpha, held at 2e-5 of its value
    for name in ("render", "render_alpha", "render_normal", "render_dist"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=0, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got["render_depth"].numpy(), np.asarray(ref["render_depth"]),
                               rtol=2e-5, atol=2e-5)
    # surf_normal crosses differences of depth-unprojected points one pixel
    # apart: a 2e-5 depth difference moves it by up to ~2e-5 / (pixel
    # footprint ~0.02) = 1e-3 on pixels at depth edges; most agree closely
    d = np.abs(got["surf_normal"].numpy() - np.asarray(ref["surf_normal"]))
    assert float(d.max()) <= 1e-3 and float(np.median(d)) <= 1e-6


_JAX_STEPS: dict = {}


def _jax_step(iteration):
    """JAX train_step_2d with depth maps at `iteration` (one compile: the
    iteration is traced)."""
    if iteration not in _JAX_STEPS:
        st, img = _jax_state2d(), _gt_maps(0)
        adam = _jax_adam(st)
        out = jstep2d.train_step_2d(
            st, jax.tree_util.tree_map(jnp.copy, adam), CAM, *map(jnp.asarray, img),
            jnp.int32(iteration), BG, opt=jstep2d.Opt2DParams(lambda_dist=100.0),
            sh_degree=3, cfg=JCFG, has_depth_cam=True, has_depth_est=True)
        _JAX_STEPS[iteration] = (st, adam, img, jax.device_get(out))
    return _JAX_STEPS[iteration]


@pytest.mark.parametrize("iteration", [8000, 8100])  # the depth-normal terms from 8001
def test_train_step_2d_matches_jax(iteration):
    st, adam, img, (js, ja, jm) = _jax_step(iteration)
    ts, tadam = _port(st, adam)
    ts2, ta2, tm = tstep2d.train_step_2d(
        ts, tadam, port_camera(), *map(torch.from_numpy, img), iteration, t(BG),
        opt=tstep2d.Opt2DParams(lambda_dist=100.0), sh_degree=3, cfg=TCFG,
        has_depth_cam=True, has_depth_est=True)
    assert float(jm.depth_loss) > 0
    for name in ("loss", "l1", "depth_loss", "psnr"):
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-5,
                                                         abs=1e-7), name
    assert int(tm.num_dropped_keys) == int(jm.num_dropped_keys) == 0
    np.testing.assert_array_equal(ts2.max_radii2d.numpy(), np.asarray(js.max_radii2d))
    np.testing.assert_array_equal(ts2.denom.numpy(), np.asarray(js.denom))
    # the gradients, recovered from the first moments (m' = 0.9 m + 0.1 g),
    # at the surfel rasterizer's gradient tolerance 3e-5·max(scale, 1)
    # (test_pallas.py:336), as tests/test_torch_train.py holds the 3DGS step
    for k in KEYS:
        m0 = np.asarray(adam.m[k], np.float64)
        g_ref = (np.asarray(ja.m[k], np.float64) - 0.9 * m0) / 0.1
        g_got = (ta2.m[k].numpy().astype(np.float64) - 0.9 * m0) / 0.1
        scale = max(np.abs(g_ref).max(), 1e-8)
        gtol = 3e-5 * max(scale, 1.0)
        np.testing.assert_allclose(g_got, g_ref, rtol=2e-4, atol=gtol, err_msg=k)
        dead = ~np.asarray(st.alive)  # the dead-row select: g = 0 exactly there
        np.testing.assert_array_equal(ta2.m[k].numpy()[dead], np.asarray(ja.m[k])[dead])
    accum = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(ts2.xyz_grad_accum.numpy(), accum, rtol=2e-4,
                               atol=3e-5 * max(np.abs(accum).max(), 1.0))
    _close(ts2.params, js.params, rtol=0, atol=1e-5)
    assert ta2.step == int(ja.step) == int(adam.step) + 1


# --- the apps ----------------------------------------------------------------

SYNTH_W, SYNTH_H = 48, 36


@pytest.fixture(scope="module")
def synth_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("train2d")
    scene = str(root / "scene")
    build_dataset(scene, n_views=4, width=SYNTH_W, height=SYNTH_H, n_gauss=48)
    return root, scene


def _argv(scene, model, *extra):
    return ["-s", scene, "-m", model, "--quiet", "--test_iterations", "-1", *extra]


def test_train_2dgs_app_trains_densifies_and_writes_the_ply(synth_scene):
    root, scene = synth_scene
    model = str(root / "torch2d")
    # opacity_cull 0.005: the 2DGS default 0.5 would prune every initial
    # point (opacity 0.1) at the first densification
    _, state, adam, log = tapp.main(_argv(
        scene, model, "--iterations", "8", "--densify_from_iter", "3",
        "--densification_interval", "6", "--densify_until_iter", "7", "--opacity_cull",
        "0.005", "--lambda_dist", "10", "--test_iterations", "8", "--device", "cpu"))
    assert len(log["loss"]) == 8 and all(np.isfinite(log["loss"]))
    assert log["dropped_keys"] == [0] * 8
    assert log["eval"] and log["eval"][-1][0] == 8
    assert state.params["scaling"].shape[1] == 2
    assert int(state.num_alive()) != 48  # the densification at iteration 6 changed the set
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
    ply = os.path.join(model, "point_cloud", "iteration_8", "point_cloud.ply")
    g = load_gaussian_ply(ply, max_sh_degree=3)
    assert g.n == int(state.num_alive()) and g.scaling.shape[1] == 2
    assert adam.step == 7  # no Adam step on the final iteration

    # the trained surfels through render_2dgs on the CPU
    os.makedirs(os.path.join(model, "refined_aligned"))
    save_gaussian_ply(os.path.join(model, "refined_aligned", "refined_1000.ply"), g)
    results = trender_app.main(["-s", scene, "-m", model, "--eval", "--split_yml_name",
                                "split.yml", "--not_render_baseline", "--device", "cpu"])
    (records,) = results.values()
    assert len(records) >= 1
    for r in records:
        assert r["num_dropped_keys"] == 0 and r["alpha_mean"] > 0.01
        with Image.open(os.path.join(model, "rendered_refined", r["image"] + ".png")) as im:
            assert np.asarray(im).shape == (SYNTH_H, SYNTH_W, 4)


def test_train_2dgs_app_matches_jax_app_and_resumes_its_checkpoint(synth_scene):
    """tests/test_torch_train.py's 5-iteration checkpoint comparison for the
    2DGS apps: the port's shared `train_3dgs.training(surfel=True)` against
    the JAX package's own 2DGS loop. Parameters within 1e-4; the first
    moments within 1e-5 · max(|m|, 1e-3) or, as the surfel step's gradients
    above, 2e-4 of their value (the surfel gradients agree to ~4e-5
    relative where the 3DGS ones agree to ~1e-5)."""
    root, scene = synth_scene
    ckpt = {}
    for name, app, extra in (("jax", japp, []), ("torch", tapp, ["--device", "cpu"])):
        model = str(root / f"{name}2d_5")
        app.main(_argv(scene, model, "--iterations", "5", "--densify_until_iter", "0",
                       "--checkpoint_iterations", "5", *extra))
        time.sleep(1.2)  # the JAX app's prefetch thread leaves within a second
        with open(os.path.join(model, "chkpnt5.pth"), "rb") as f:
            ckpt[name] = pickle.load(f)
    j, p = ckpt["jax"], ckpt["torch"]
    assert sorted(p) == sorted(j) and p["iteration"] == j["iteration"] == 5
    assert p["adam_step"] == j["adam_step"] == 4
    np.testing.assert_array_equal(p["alive"], j["alive"])
    assert p["params"]["scaling"].shape[1] == j["params"]["scaling"].shape[1] == 2
    for k in KEYS:
        np.testing.assert_allclose(p["params"][k], j["params"][k], rtol=0, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(p["adam_m"][k], j["adam_m"][k], rtol=2e-4,
                                   atol=1e-5 * max(np.abs(j["adam_m"][k]).max(), 1e-3),
                                   err_msg=k)
    model = str(root / "resumed2d")
    _, state, adam, log = tapp.main(_argv(
        scene, model, "--iterations", "7", "--densify_until_iter", "0", "--start_checkpoint",
        os.path.join(str(root / "jax2d_5"), "chkpnt5.pth"), "--device", "cpu"))
    assert len(log["loss"]) == 2 and adam.step == 5
    assert state.params["scaling"].shape[1] == 2


def test_2dgs_apps_raise_without_gpu(synth_scene, monkeypatch):
    root, scene = synth_scene
    # --gui with no viewer attached (on a port the OS picks) trains to the end
    _, _, adam, log = tapp.main(_argv(scene, str(root / "gui"), "--gui", "--port", "0",
                                      "--iterations", "3", "--densify_until_iter", "0",
                                      "--device", "cpu"))
    assert len(log["loss"]) == 3 and adam.step == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(_argv(scene, str(root / "nogpu")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender_app.main(["-s", scene, "-m", str(root / "nogpu"), "--not_render_baseline"])
