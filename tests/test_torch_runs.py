"""Port parity, long training runs: scorp_tpu_torch.runs (the scene
generators, `build_dataset`, the runs' summary line) against the JAX
package's scripts/convergence_run.py and scripts/densify_scale_run.py, and
the port's 3DGS and 2DGS apps against the JAX apps through several densify
rounds, on the CPU at a tiny size."""

import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from scorp_tpu.apps import train_2dgs as japp2d
from scorp_tpu.apps import train_3dgs as japp
from scorp_tpu_torch.apps import train_2dgs as tapp2d
from scorp_tpu_torch.apps import train_3dgs as tapp
from scorp_tpu_torch.core.plyio import load_gaussian_ply
from scorp_tpu_torch.runs import convergence_run as tconv
from scorp_tpu_torch.runs import densify_scale_run as tdens
from scripts import convergence_run as jconv
from scripts import densify_scale_run as jdens
from tests.synth import build_dataset as build_synth

torch.set_num_threads(2)

FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@pytest.mark.parametrize("gen, ref, n, seed", [
    (tconv.make_scene_gaussians, jconv.make_scene_gaussians, 2_000, 7),
    (tconv.make_scene_gaussians, jconv.make_scene_gaussians, 1_010, 3),
    (tdens.make_textured_gaussians, jdens.make_textured_gaussians, 2_000, 11),
    (tdens.make_textured_gaussians, jdens.make_textured_gaussians, 1_008, 5),
])
def test_scene_generators_are_bit_equal_to_the_scripts(gen, ref, n, seed):
    got, want = gen(n=n, seed=seed), ref(n=n, seed=seed)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for angle in (0.0, 1.3, 4.0):
        for a, b in zip(tconv.orbit_pose(angle, 1.9, 0.3), jconv.orbit_pose(angle, 1.9, 0.3)):
            np.testing.assert_array_equal(a, b)


# the JAX script's build_dataset at 8 views, 64x48, with its generator cut
# to 2,000 gaussians and 500 init points (~12 s on the CPU)
N_SMALL, N_INIT = 2_000, 500


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    jax_scene, port_scene = str(root / "jax"), str(root / "port")
    gen = jdens.make_textured_gaussians
    jdens.make_textured_gaussians = lambda seed: gen(n=N_SMALL, seed=seed)
    try:
        jdens.build_dataset(jax_scene, n_views=8, width=64, height=48, n_init=N_INIT)
    finally:
        jdens.make_textured_gaussians = gen
    info = tdens.build_dataset(port_scene, n_views=8, width=64, height=48, n_init=N_INIT,
                               n=N_SMALL, device="cpu")
    return root, jax_scene, port_scene, info


def test_build_dataset_matches_the_script(scenes):
    _, jax_scene, port_scene, info = scenes
    for rel in ("sparse/cameras.bin", "sparse/images.bin", "sparse/points3D.bin", "split.yml"):
        with open(os.path.join(jax_scene, rel), "rb") as a, \
                open(os.path.join(port_scene, rel), "rb") as b:
            assert a.read() == b.read(), rel
    names = sorted(os.listdir(os.path.join(jax_scene, "images")))
    assert names == sorted(os.listdir(os.path.join(port_scene, "images"))) and len(names) == 8
    off, total = 0, 0
    for name in names:
        a = np.asarray(Image.open(os.path.join(jax_scene, "images", name)), np.int16)
        b = np.asarray(Image.open(os.path.join(port_scene, "images", name)), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        d = np.abs(a - b)
        assert d.max() <= 1, name
        off, total = off + int((d > 0).sum()), total + d.size
    assert off <= 0.001 * total, (off, total)
    # every view rendered once, at the JAX scripts' key capacity, dropping nothing
    assert info["renders"] == 8 and info["dropped_at_jax_capacity"] == [0] * 8
    assert info["max_keys"] == tconv.JAX_GT_MAX_KEYS
    np.testing.assert_array_equal(info["state"].params["xyz"][:N_SMALL].numpy(),
                                  tdens.make_textured_gaussians(n=N_SMALL).xyz)


def test_write_scene_regrows_until_no_key_drops(tmp_path, monkeypatch):
    # a key capacity far too small for the scene: each view renders again
    # with doubled capacities until it drops nothing
    monkeypatch.setattr(tconv, "JAX_GT_MAX_KEYS", 1 << 6)
    g = tconv.make_scene_gaussians(n=600, seed=2)
    info = tconv.write_scene(str(tmp_path), g, n_views=2, width=48, height=36, fov=1.1,
                             seed=2, n_init=50, device="cpu")
    assert all(d > 0 for d in info["dropped_at_jax_capacity"])
    assert info["renders"] > 2 and info["max_keys"] > 1 << 6


@pytest.mark.parametrize("run", [tconv, tdens])
def test_run_main_prints_the_summary_of_its_log(run, scenes, capsys, monkeypatch):
    root, _, port_scene, _ = scenes
    out = root / run.__name__.rsplit(".", 1)[1]
    os.makedirs(out)
    os.symlink(port_scene, out / "scene")
    argv = [str(out), "--iters", "30", "--device", "cpu"]
    if run is tdens:
        argv += ["--pilot", "--grad_threshold", "1e-4"]
    argv += ["--", "--densify_from_iter", "5", "--densification_interval", "5",
             "--opacity_reset_interval", "20", "--opacity_cull", "0.005"]
    summary, (_, state, _, log) = run.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(summary))
    assert set(printed) == {
        "run", "device", "iterations", "wall_s", "it_per_s", "final_alive", "peak_alive",
        "densify", "capacity_growths", "raster_regrows", "sh_degree_steps", "dropped_keys_train",
        "dropped_keys_eval", "eval", "nonfinite_losses", "nonfinite_rows", "peak_device_mib"}
    assert printed["iterations"] == 30 == len(log["loss"])
    assert printed["densify"] == [list(r) for r in log["densify"]] and len(log["densify"]) == 5
    assert all(len(r) == 5 and r[4] == 0 for r in printed["densify"])
    # the PLY is saved before the last iteration's densify round
    assert printed["densify"][-1][0] == 30 and printed["densify"][-1][3] == int(state.num_alive())
    assert printed["final_alive"] == printed["densify"][-1][1]
    assert printed["peak_alive"] == max([printed["densify"][0][1]]
                                        + [r[3] for r in printed["densify"]])
    assert printed["capacity_growths"] == [list(c) for c in log["capacity"]]
    assert printed["raster_regrows"] == [list(r) for r in log["raster_keys"]]
    assert printed["sh_degree_steps"] == [] == log["sh_degree"]  # the first step is at 1000
    assert printed["dropped_keys_train"] == [[i + 1, d] for i, d in
                                             enumerate(log["dropped_keys"]) if d]
    assert printed["dropped_keys_eval"] == [[30, 0]] == [list(e) for e in log["eval_dropped_keys"]]
    (it, res), = log["eval"]
    assert printed["eval"] == [{"iteration": it, "test": dict(zip(("l1", "psnr"), res["test"])),
                                "train": dict(zip(("l1", "psnr"), res["train"]))}]
    assert printed["nonfinite_losses"] == 0 and printed["peak_device_mib"] is None
    assert printed["nonfinite_rows"] == dict.fromkeys(FIELDS, 0)
    ply = load_gaussian_ply(os.path.join(out, "model", "point_cloud", "iteration_30",
                                         "point_cloud.ply"))
    assert ply.n == printed["final_alive"]


def test_runs_raise_without_gpu(scenes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (tconv, tdens):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main([str(scenes[0] / "nogpu")])
    assert not os.path.exists(scenes[0] / "nogpu")


# --- the apps through several densify rounds, against the JAX apps --------

ITERS = 40
DENSIFY = ["--densify_from_iter", "5", "--densification_interval", "5",
           "--opacity_reset_interval", "20", "--opacity_cull", "0.005"]


def _record_jax(monkeypatch, app, step_name, eval_name):
    """Wrap the JAX app's densify, candidate count, step and evaluation to
    record what the port's log holds."""
    rec = {"loss": [], "densify": [], "cand": [], "eval": []}
    count, dap, step = app.count_densify_candidates, app.densify_and_prune, getattr(app, step_name)
    evaluate = getattr(app, eval_name)

    def counted(state, thr):
        n = count(state, thr)
        rec["cand"].append(int(n))
        return n

    def densified(state, adam, *a, **k):
        before = int(state.num_alive())
        state, adam, dropped = dap(state, adam, *a, **k)
        rec["densify"].append((before, rec["cand"][-1], int(state.num_alive()), int(dropped)))
        return state, adam, dropped

    def stepped(*a, **k):
        out = step(*a, **k)
        rec["loss"].append(float(out[2].loss))
        return out

    def evaluated(*a, **k):
        res = evaluate(*a, **k)
        rec["eval"].append(res)
        return res

    monkeypatch.setattr(app, eval_name, evaluated)
    monkeypatch.setattr(app, "count_densify_candidates", counted)
    monkeypatch.setattr(app, "densify_and_prune", densified)
    monkeypatch.setattr(app, step_name, stepped)
    return rec


@pytest.mark.parametrize("surfel", [False, True])
def test_apps_match_jax_through_densify_rounds(surfel, tmp_path, monkeypatch):
    scene = str(tmp_path / "scene")
    build_synth(scene, n_views=4, width=48, height=36, n_gauss=48)
    jmod, tmod = (japp2d, tapp2d) if surfel else (japp, tapp)
    rec = _record_jax(monkeypatch, jmod, *(("train_step_2d", "evaluate2d") if surfel
                                           else ("train_step", "evaluate")))
    argv = ["-s", scene, "--quiet", "--iterations", str(ITERS), "--test_iterations", str(ITERS),
            *DENSIFY]
    jmod.main(argv + ["-m", str(tmp_path / "jax")])
    time.sleep(1.2)  # the JAX app's prefetch thread leaves within a second
    _, _, _, log = tmod.main(argv + ["-m", str(tmp_path / "port"), "--device", "cpu"])
    rounds = [r[1:] for r in log["densify"]]
    assert [r[0] for r in log["densify"]] == list(range(10, ITERS + 1, 5))
    assert len(rec["densify"]) == len(rounds) == 7
    # equal through the first round: the same steps, candidates and counts
    assert rounds[0] == rec["densify"][0] and rounds[0][1] > 0
    np.testing.assert_allclose(log["loss"][:10], rec["loss"][:10], rtol=2e-5, atol=0)
    # after it the split samples differ (torch.Generator vs jax.random):
    # final counts within a quarter (3DGS 535 vs 552, 2DGS 30 vs 26 here),
    # train PSNR within 0.5 dB (0.05 and 0.001 dB apart here)
    assert all(r[3] == 0 for r in rounds)
    jn, tn = rec["densify"][-1][2], rounds[-1][2]
    assert abs(tn - jn) <= 0.25 * jn, (tn, jn)
    (_, res), = log["eval"]
    (jres,) = rec["eval"]
    assert abs(res["train"][1] - jres["train"][1]) <= 0.5, (res, jres)
