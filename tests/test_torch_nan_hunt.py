"""Port parity, the NaN hunt and its replay: scorp_tpu_torch.runs.nan_hunt and
runs.nan_replay against the JAX package's scripts/nan_hunt.py and
scripts/nan_replay.py on the CPU, at the tiny densification scene (8 views at
64x48, 2,000 ground-truth gaussians, a 500-point init) with densification
every 5 iterations from 5.

Both hunts run with a planted fault: after step 3 the quaternion of one alive
row is set to zero, which stays finite in both packages (the norm is clamped
inside the square root), and after step 7 the DC colour of every alive row
is set to 1e30, which keeps the rendered image finite (~1e29) but overflows
the SSIM's second moments, so step 8's loss is NaN. Before step 5 each hunt's
step inputs are dumped with its own package's `dump_step_inputs`, a clean
state that both packages' replays read."""

import contextlib
import dataclasses
import io
import os
import random
import re
import sys
import time
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scorp_tpu.apps.train_3dgs as japp
import scorp_tpu.train as jtrain
from scorp_tpu_torch.apps import train_3dgs as tapp
from scorp_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
from scorp_tpu_torch.ops.raster import RasterConfig
from scorp_tpu_torch.runs import densify_scale_run as tdens
from scorp_tpu_torch.runs import nan_hunt, nan_replay
from scorp_tpu_torch.train import step as tstep
from scripts import nan_hunt as jhunt
from scripts import nan_replay as jreplay

torch.set_num_threads(2)

ITERS = 40
ZERO_QUAT_AFTER, PLANT_AFTER, CLEAN_DUMP_AT = 3, 7, 5
DENSIFY = dict(densify_from_iter=5, densification_interval=5, opacity_cull=0.005)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("nan_hunt")
    tdens.build_dataset(str(root / "scene"), n_views=8, width=64, height=48, n=2000,
                        n_init=500, device="cpu")
    return root


def _outdir(scene, name):
    out = scene / name
    os.makedirs(out)
    os.symlink(scene / "scene", out / "scene")
    return str(out)


@contextlib.contextmanager
def _patched(mod, name, value):
    saved = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _densify_every_5(orig):
    return lambda *a, **k: dataclasses.replace(orig(*a, **k), **DENSIFY)


def _run_jax_hunt(outdir):
    """scripts/nan_hunt.py with the planted faults, its stdout, the clean
    dump and JAX's own step on it (opt, cfg, outputs)."""
    rec = {}
    step = jtrain.train_step

    def planted(*a, **k):
        it = int(a[6])
        if it == CLEAN_DUMP_AT:
            cam = a[2]
            jhunt.dump_step_inputs(os.path.join(outdir, "clean.npz"), a[0], a[1],
                                   type("Cam", (), {"to_jax": lambda self: cam})(), np.asarray(a[7]),
                                   it, k["sh_degree"], a[3])
            rec.update(opt=k["opt"], cfg=k["cfg"])
        state, adam, metrics = step(*a, **k)
        if it == CLEAN_DUMP_AT:
            rec["out"] = jax.device_get((state, adam, metrics))
        p = dict(state.params)
        if it == ZERO_QUAT_AFTER:
            row = int(np.flatnonzero(np.asarray(state.alive))[0])
            p["rotation"] = p["rotation"].at[row].set(0.0)
        if it == PLANT_AFTER:
            p["f_dc"] = jnp.where(state.alive[:, None, None], 1e30, p["f_dc"])
        return state._replace(params=p), adam, metrics

    buf = io.StringIO()
    with _patched(japp, "opt_params_from_args", _densify_every_5(japp.opt_params_from_args)), \
            _patched(jtrain, "train_step", planted), contextlib.redirect_stdout(buf), \
            _patched(sys, "argv", ["nan_hunt.py", outdir, "--iters", str(ITERS)]):
        jhunt.main()
    time.sleep(1.2)  # the JAX sampler's prefetch thread leaves within a second
    return buf.getvalue(), rec


def _run_port_hunt(outdir):
    rec = {}
    step = nan_hunt.train_step

    def planted(*a, **k):
        it = a[6]
        if it == CLEAN_DUMP_AT:
            nan_hunt.dump_step_inputs(os.path.join(outdir, "clean.npz"), a[0], a[1], a[2], a[7],
                                      it, k["sh_degree"], a[3])
        state, adam, metrics = step(*a, **k)
        if it == CLEAN_DUMP_AT:
            rec["loss"] = float(metrics.loss)
        p = dict(state.params)
        if it == ZERO_QUAT_AFTER:
            p["rotation"] = p["rotation"].clone()
            p["rotation"][int(state.alive.nonzero()[0, 0])] = 0.0
        if it == PLANT_AFTER:
            p["f_dc"] = torch.where(state.alive[:, None, None], 1e30, p["f_dc"])
        return state._replace(params=p), adam, metrics

    buf = io.StringIO()
    with _patched(tapp, "opt_params_from_args", _densify_every_5(tapp.opt_params_from_args)), \
            _patched(nan_hunt, "train_step", planted), contextlib.redirect_stdout(buf):
        result = nan_hunt.main([outdir, "--iters", str(ITERS), "--device", "cpu"])
    return buf.getvalue(), rec, result


@pytest.fixture(scope="module")
def hunts(scene):
    jax_out = _outdir(scene, "jax")
    jax_log, jax_rec = _run_jax_hunt(jax_out)
    port_out = _outdir(scene, "port")
    port_log, port_rec, port_result = _run_port_hunt(port_out)
    return {"jax": (jax_out, jax_log, jax_rec), "port": (port_out, port_log, port_rec,
                                                          port_result)}


def _close(got: dict, ref: dict, **tol):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **tol)


def _assert_step_matches_jax(t_out, j_out, adam_in):
    """tests/test_torch_train.py::test_train_step_matches_jax's tolerances."""
    (ts, ta, tm), (js, ja, jm) = t_out, j_out
    for name in ("loss", "l1", "psnr"):
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)), rel=1e-5,
                                                         abs=1e-7), name
    assert int(tm.num_alive) == int(jm.num_alive)
    np.testing.assert_array_equal(ts.max_radii2d.numpy(), np.asarray(js.max_radii2d))
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    for k in ts.params:
        m0 = adam_in.m[k].numpy().astype(np.float64)
        g_ref = (np.asarray(ja.m[k], np.float64) - 0.9 * m0) / 0.1
        g_got = (ta.m[k].numpy().astype(np.float64) - 0.9 * m0) / 0.1
        scale = max(np.abs(g_ref).max(), 1e-8)
        gtol = 2e-5 * max(scale, 1.0)
        np.testing.assert_allclose(g_got, g_ref, rtol=0, atol=gtol, err_msg=k)
        np.testing.assert_allclose(ta.m[k].numpy(), ja.m[k], rtol=1e-6, atol=0.1 * gtol,
                                   err_msg=k)
        np.testing.assert_allclose(ta.v[k].numpy(), ja.v[k], rtol=1e-6,
                                   atol=0.002 * scale * gtol, err_msg=k)
    accum = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(ts.xyz_grad_accum.numpy(), accum, rtol=0,
                               atol=2e-5 * max(np.abs(accum).max(), 1.0))
    _close(ts.params, js.params, rtol=0, atol=1e-5)
    assert ta.step == int(ja.step)


def test_jax_dump_replays_in_the_port_and_round_trips(hunts, tmp_path):
    jax_out, _, rec = hunts["jax"]
    path = os.path.join(jax_out, "clean.npz")
    state, adam, cam, bg, it, sh, gt = nan_replay.load(path, "cpu")
    assert (it, sh) == (CLEAN_DUMP_AT, 0)
    # one port step on the JAX state, against JAX's own step on it in the hunt
    zeros = torch.zeros(1, cam.height, cam.width)
    opt = tstep.OptParams(**dataclasses.asdict(rec["opt"]))
    t_out = tstep.train_step(state, adam, cam, gt, zeros, zeros, it, bg, opt=opt, sh_degree=sh,
                             cfg=RasterConfig(max_keys=rec["cfg"].max_keys,
                                              stream_keys=rec["cfg"].stream_keys))
    _assert_step_matches_jax(t_out, rec["out"], adam)
    # the port's dump of that state, read by the JAX script, is the JAX dump
    again = str(tmp_path / "again.npz")
    nan_hunt.dump_step_inputs(again, state, adam, cam, bg, it, sh, gt)
    want, got = np.load(path), np.load(again)
    assert sorted(want.files) == sorted(got.files)
    for k in want.files:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate, jadam, jcam, jbg, jit, jsh, jgt = jreplay.load(again)
    for k in jstate.params:
        np.testing.assert_array_equal(np.asarray(jstate.params[k]), want[f"param.{k}"])
        np.testing.assert_array_equal(np.asarray(jadam.m[k]), want[f"adam_m.{k}"])
        np.testing.assert_array_equal(np.asarray(jadam.v[k]), want[f"adam_v.{k}"])
    for k in ("alive", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(np.asarray(getattr(jstate, k)), want[k])
    for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(np.asarray(getattr(jcam, k)), want[k])
    assert (jcam.width, jcam.height, jit, jsh) == (64, 48, it, sh)
    assert int(jadam.step) == int(want["adam_step"])
    np.testing.assert_array_equal(np.asarray(jbg), want["bg"])
    np.testing.assert_array_equal(np.asarray(jgt), want["gt_img"])


@pytest.mark.parametrize("name", ["clean.npz", "fault_iter8.npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_diagnose_inputs_prints_the_same_lines(hunts, writer, name):
    path = os.path.join(hunts[writer][0], name)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jst, _, jcam, *_ = jreplay.load(path)
    with contextlib.redirect_stdout(jbuf):
        jreplay.diagnose_inputs(jst, jcam)
    tst, _, tcam, *_ = nan_replay.load(path, "cpu")
    with contextlib.redirect_stdout(tbuf):
        nan_replay.diagnose_inputs(tst, tcam)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert tbuf.getvalue().startswith("alive rows: 500\n")


def _fault_lines(log):
    found = re.search(r"\[iter (\d+)\] NON-FINITE detected: loss=(\S+) bad=(\{.*?\}) ", log)
    snap = re.search(r"=== replaying from iter (\d+) to (\d+)", log)
    replay = re.search(r"\[REPLAY iter (\d+)\] loss=(\S+) bad=(\{.*\})", log)
    dump = re.findall(r"dumped faulting-step inputs to (\S+)", log)[-1]  # after clean.npz
    return found, snap, replay, dump


def test_planted_fault_found_rewound_and_dumped_as_in_jax(hunts):
    jax_out, jax_log, _ = hunts["jax"]
    port_out, port_log, _, result = hunts["port"]
    (jf, js, jr, jd), (tf, ts, tr, td) = _fault_lines(jax_log), _fault_lines(port_log)
    # found at step 8 (the zero quaternion after step 3 stayed finite) by the
    # loss check, before any full check
    assert tf.groups()[:1] == jf.groups()[:1] == ("8",)
    assert tf.group(2) == jf.group(2) == "nan" and tf.group(3) == jf.group(3) == "{}"
    assert ts.groups() == js.groups() == ("0", "8")
    assert tr.group(1) == jr.group(1) == "8"
    assert set(eval(tr.group(3))) == set(eval(jr.group(3)))
    assert os.path.basename(td) == os.path.basename(jd) == "fault_iter8.npz"
    assert "pre-step param state: {}" in port_log and "pre-step param state: {}" in jax_log
    assert result["fault"] == 8 and result["snapshot"] == 0 and result["bad"] == {}
    assert result["dump"] == td
    # the replay reproduced the first pass's losses
    assert [result["replay_losses"][i] for i in range(1, 8)] == result["losses"][:7]
    # the two dumps: the same pre-step state, at test 1's tolerances once
    # for each of the PLANT_AFTER steps both states have taken (parameters
    # 1e-5 absolute, moments and xyz_grad_accum 2e-5 x their largest value,
    # the integer statistics exact), the planted colours equal
    want, got = np.load(jd), np.load(td)
    assert sorted(want.files) == sorted(got.files)
    for k in want.files:
        if k.startswith("param."):
            tol = PLANT_AFTER * 1e-5
        elif k.startswith("adam_") or k == "xyz_grad_accum":
            tol = PLANT_AFTER * 2e-5 * max(np.abs(want[k]).max(), 1e-8)
        else:
            tol = 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    alive = got["alive"]
    assert (got["param.f_dc"][alive] == 1e30).all() and np.isfinite(got["param.f_dc"]).all()
    assert all(np.isfinite(got[k]).all() for k in got.files)


def test_replay_names_the_loss_on_the_fault_and_nothing_on_the_clean_dump(hunts):
    port_out, _, rec, _ = hunts["port"]
    with contextlib.redirect_stdout(io.StringIO()):
        fault = nan_replay.main([os.path.join(port_out, "fault_iter8.npz"), "--device", "cpu"])
        clean = nan_replay.main([os.path.join(port_out, "clean.npz"), "--device", "cpu"])
    assert fault["stage"] == "loss" and not np.isfinite(fault["loss"])
    assert fault["post_step"]["f_dc"] > 0
    # the replay's loss is the hunt's on those inputs, bit for bit
    assert clean["stage"] is None and clean["post_step"] == {} and clean["loss"] == rec["loss"]


@pytest.fixture(scope="module")
def clean_hunt(scene):
    """A clean 40-iteration hunt, each snapshot recorded with a copy of its
    tensors, and apps.train_3dgs.training's steps on the same scene."""
    snaps = []
    take = nan_hunt.snapshot

    def recorded(*a):
        snap = take(*a)
        _, state, adam, gen_state, _ = snap
        copies = [t.clone() for t in (*state.params.values(), *state[1:], *adam.m.values(),
                                      *adam.v.values())]
        snaps.append((snap, copies, gen_state.clone()))
        return snap

    out = _outdir(scene, "clean")
    with _patched(tapp, "opt_params_from_args", _densify_every_5(tapp.opt_params_from_args)), \
            _patched(nan_hunt, "snapshot", recorded), contextlib.redirect_stdout(io.StringIO()):
        result = nan_hunt.main([out, "--iters", str(ITERS), "--device", "cpu"])
    steps = []
    step = tapp.train_step

    def stepped(*a, **k):
        state, adam, m = step(*a, **k)
        steps.append((float(m.loss), int(m.num_alive)))
        return state, adam, m

    args = ["-s", str(scene / "scene"), "-m", str(scene / "trained"), "--eval",
            "--split_yml_name", "split.yml", "--iterations", str(ITERS)]
    for k, v in DENSIFY.items():
        args += [f"--{k}", str(v)]
    parser = ArgumentParser()
    for group in (ModelParams, OptimizationParams, PipelineParams):
        group.add_to_parser(parser, group.__name__)
    a = parser.parse_args(args)
    random.seed(0)  # as train_3dgs.main seeds before training()
    np.random.seed(0)
    with _patched(tapp, "train_step", stepped), contextlib.redirect_stdout(io.StringIO()):
        tapp.training(ModelParams.extract(a).finalize(), OptimizationParams.extract(a),
                      PipelineParams.extract(a), [], [], [], None, -1, quiet=True,
                      device="cpu")
    return result, snaps, steps


def test_clean_hunt_equals_training_step_for_step(clean_hunt):
    result, _, steps = clean_hunt
    assert result["fault"] is None and result["dump"] is None
    assert len(result["losses"]) == ITERS == len(steps)
    assert result["losses"] == [s[0] for s in steps]
    assert result["alive"] == [s[1] for s in steps]
    assert result["alive"][-1] > 4 * result["alive"][0]  # seven densify rounds grew it


def test_snapshots_are_unchanged_by_later_steps(clean_hunt):
    _, snaps, _ = clean_hunt
    assert [s[0][0] for s in snaps] == [0, 20, 40]
    assert snaps[0][0][1].capacity < snaps[-1][0][1].capacity  # capacity grew in between
    for (it, state, adam, gen_state, _), copies, gen_copy in snaps:
        now = [*state.params.values(), *state[1:], *adam.m.values(), *adam.v.values()]
        assert all(torch.equal(a, b) for a, b in zip(now, copies)), it
        assert torch.equal(gen_state, gen_copy), it


def test_hunt_and_replay_raise_without_gpu(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nan_hunt.main([str(scene / "nogpu")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nan_replay.main([str(scene / "missing.npz")])
    assert not os.path.exists(scene / "nogpu")


def test_an_overflowing_scale_is_non_finite_in_both_packages(hunts):
    """A log-scale of 100 on one alive row (exp overflows f32, so its
    covariance is inf): both preprocesses cull the row (a NaN conic, an
    empty tile rect), and both renders stay finite, but the isotropic term
    |s - mean(s)| is NaN on the row and the step multiplies it by its zero
    warm-up weight, so the loss is NaN in both packages at that step. After
    the step the same rows are non-finite in both, the row's position,
    scale and rotation among them (JAX's golden compositor adds row 0's
    opacity, below)."""
    jax_out, _, rec = hunts["jax"]
    path = os.path.join(jax_out, "clean.npz")
    jst, jad, jcam, jbg, it, sh, jgt = jreplay.load(path)
    row = int(np.flatnonzero(np.asarray(jst.alive))[0])
    jst = jst._replace(params={**jst.params,
                               "scaling": jst.params["scaling"].at[row].set(100.0)})
    zeros = jnp.zeros((1, jcam.height, jcam.width))
    js, _, jm = jtrain.train_step(jst, jad, jcam, jgt, zeros, zeros, jnp.int32(it), jbg,
                                  opt=rec["opt"], sh_degree=sh, cfg=rec["cfg"],
                                  has_depth_cam=False, has_depth_est=False)
    tst, tad, tcam, tbg, _, _, tgt = nan_replay.load(path, "cpu")
    scaling = tst.params["scaling"].clone()
    scaling[row] = 100.0
    tst = tst._replace(params={**tst.params, "scaling": scaling})
    zeros = torch.zeros(1, tcam.height, tcam.width)
    ts, _, tm = tstep.train_step(
        tst, tad, tcam, tgt, zeros, zeros, it, tbg,
        opt=tstep.OptParams(**dataclasses.asdict(rec["opt"])), sh_degree=sh,
        cfg=RasterConfig(max_keys=rec["cfg"].max_keys, stream_keys=rec["cfg"].stream_keys))
    assert np.isnan(float(jm.loss)) and np.isnan(float(tm.loss))
    for k in ("xyz", "scaling", "rotation"):
        assert not np.isfinite(np.asarray(js.params[k])[row]).any(), k
        assert not torch.isfinite(ts.params[k][row]).any(), k
    for k in js.params:
        jbad = ~np.isfinite(np.asarray(js.params[k])).reshape(len(jst.alive), -1).all(1)
        tbad = ~torch.isfinite(ts.params[k]).reshape(len(jst.alive), -1).all(1).numpy()
        if k == "opacity":
            # JAX's golden compositor gathers row 0 for every empty tile-list
            # slot (`xla.py:_chunk_alphas`, `max(ids, 0)` under a where), so
            # row 0's opacity gradient there is 0 x exp(NaN): one row more
            # in JAX, and only row 0 (the overflowing row is row 0 here)
            assert np.flatnonzero(jbad & ~tbad).tolist() in ([], [0]), k
            jbad[0] = tbad[0]
        np.testing.assert_array_equal(tbad, jbad, err_msg=k)
