"""The 2DGS viewer frame against the benchmark's plain surfel reference, on
the CPU: `render2d`'s eval path (the plain K4 and the plain routing) held
against `bench_port/reference/raster2d.py` on seeded random surfels; the
reference with its blend in bfloat16 (the benchmark's control) failing
those tolerances; the `room2dgs-render` cell run whole at a tiny size in a
fresh process; the two spans the cell's readers read; and those readers
and K4's work model on hand-made inputs."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_port.loops.render2d import reference_maps
from bench_port.reference import camera, raster2d
from scorp_tpu_torch.core.camera import make_camera
from scorp_tpu_torch.render2d import render2d
from scorp_tpu_torch.train import state_from_numpy
from scorp_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 3000
SEEDS = (0, 1)
POSE = dict(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=2.0 * np.arctan(np.tan(0.5) * H / W))
NEW_SPANS = ("raster.surfel_cull", "render.surfel_maps")

# Tolerances, each with its reason. The plain K4 and the reference compute
# alpha by two formulas (exp2 of a folded exponent; opacity times exp), so
# their float32 transmittances part by a few ulps.
COLOR_MEAN = 2e-6  # the mean stays at round-off (~1.5e-7 read); bfloat16 reads ~1e-3
# a pixel whose transmittance lands within those ulps of the 1e-4 stop can
# take or drop one last surfel, whose weight is below 1e-4: the largest gap
# of alpha, a colour channel or a normal component a pixel may show
PIXEL_MAX = 1e-4
DEPTH_REL = 1e-4   # the median depth's own round-off, relative (~2e-8 read)
# a pixel whose transmittance lands within those ulps of 0.5 takes the
# median from the next surfel: a whole depth step; a tie that rare may
# happen at a pixel or two of a frame, never more
DEPTH_TIES = 2
SURF_NORMAL_MEAN = 1e-5  # away from such ties, round-off of depth differences (~3e-7 read)


def _scene(seed: int, n: int = N):
    """n random surfels 2-5 in front of a camera at the origin, 5% dead."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(2.0, 5.0, n)], 1)
    params = dict(xyz=xyz, f_dc=rng.normal(0, 0.5, (n, 1, 3)),
                  f_rest=rng.normal(0, 0.05, (n, 15, 3)),
                  scaling=np.log(rng.uniform(0.02, 0.12, (n, 2))),
                  rotation=rng.normal(size=(n, 4)), opacity=rng.normal(0, 1.5, (n, 1)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return params, rng.uniform(size=n) > 0.05


def _program_maps(params, alive):
    state = state_from_numpy(params, alive, device="cpu")
    cam = make_camera(POSE["R"], POSE["T"], POSE["fovx"], POSE["fovy"], W, H, device="cpu")
    out = render2d(cam, state, np.zeros(3, np.float32), sh_degree=3, depth_ratio=1.0)
    return dict(image=out["render"], alpha=out["render_alpha"], depth=out["render_depth"],
                normal=out["render_normal"], surf_normal=out["surf_normal"])


def _reference_maps(params, alive, dtype=torch.float32):
    cam = camera.camera(POSE, W, H, torch.device("cpu"))
    f = raster2d.render({k: torch.as_tensor(v) for k, v in params.items()},
                        torch.as_tensor(alive), cam, torch.zeros(3), dtype=dtype)
    return dict(image=f.color, **reference_maps(f, cam))


@pytest.fixture(scope="module")
def frames():
    """{seed: (program, reference, bfloat16 reference)} maps."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = {}
        for seed in SEEDS:
            params, alive = _scene(seed)
            out[seed] = (_program_maps(params, alive), _reference_maps(params, alive),
                         _reference_maps(params, alive, torch.bfloat16))
        return out
    finally:
        torch.set_num_threads(n)


def _failures(got: dict, want: dict) -> list:
    """The tolerances `got` misses against the reference's maps `want` (a
    NaN misses)."""
    bad = []
    if not float((got["image"] - want["image"]).abs().mean()) <= COLOR_MEAN:
        bad.append("color mean")
    for key in ("image", "alpha", "normal"):
        if not float((got[key] - want[key]).abs().max()) <= PIXEL_MAX:
            bad.append(key + " max")
    ties = (got["depth"] - want["depth"]).abs() > DEPTH_REL * want["depth"].abs().clamp_min(1.0)
    if not int(ties.sum()) <= DEPTH_TIES:
        bad.append("median depth")
    # depth_to_normal crosses the central differences: a tie moves its 3x3
    # (a frame of ties leaves no pixel to compare: a NaN, which misses)
    near_tie = torch.nn.functional.max_pool2d(ties.float()[None], 3, 1, 1)[0] > 0
    gap = (got["surf_normal"] - want["surf_normal"]).abs()
    if not float(gap[:, ~near_tie[0]].mean()) <= SURF_NORMAL_MEAN:
        bad.append("surf_normal mean")
    return bad


@pytest.mark.parametrize("seed", SEEDS)
def test_render2d_matches_the_plain_reference(frames, seed):
    prog, ref, _ = frames[seed]
    assert _failures(prog, ref) == []
    assert float(ref["alpha"].mean()) > 0.3  # the frame is covered, not empty


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_blend_fails_the_tolerances(frames, seed):
    _, ref, low = frames[seed]
    assert {"color mean", "median depth", "surf_normal mean"} <= set(_failures(low, ref))


def test_world_normal_is_the_view_normal_rotated():
    """reference_maps turns the view normal to world space by Rw^T."""
    pose = dict(R=np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
                T=np.zeros(3), fovx=1.0, fovy=0.8)
    cam = camera.camera(pose, 4, 2, torch.device("cpu"))
    view = torch.zeros(3, 2, 4)
    view[0] = 1.0  # +x in the camera
    frame = raster2d.Frame(torch.zeros(3, 2, 4), torch.ones(1, 2, 4), view,
                           torch.ones(1, 2, 4), 0, 0)
    world = reference_maps(frame, cam)["normal"]
    expect = torch.as_tensor(pose["R"][:, 0], dtype=torch.float32)  # the camera's x in world
    assert torch.allclose(world[:, 0, 0], expect)


# the whole cell at a tiny size, in a fresh process: this one has imported JAX

TINY = dict(n_gaussians=3000, width=96, height=64, n_views=16, test_every=8)
TINY_TRAFFIC = dict(traced_units=2, counted_units=1, warmup_frames=1, sampled_from_first=4,
                    sampled_frames=2)
CPU_RATES = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12, "pcie_bytes_per_s": 64e9}
CELL_RUN = """
import json, sys, tempfile, time, torch
from bench_port import harness
from bench_port.loops import render2d as loop
torch.set_num_threads(2)
cell = harness.cell_of("room2dgs-render")
cell["config"].update(%r)
cell["traffic"].update(%r)
seen = []
context = loop.trace_context
def spy(*args):
    ctx = context(*args)
    seen.append(dict(traced_units=ctx["traced_units"],
                     frames=ctx["profile"]["labels"]["unit.render"]["count"]))
    return ctx
loop.trace_context = spy
with tempfile.TemporaryDirectory() as tmp:
    res = harness.run_cell(cell, 2**31 + 12345, 0.5, True, torch.device("cpu"), time.time(),
                           tmp, {"peaks": %r})
print(json.dumps(dict(result=res, forbidden=harness.loaded_forbidden(), seen=seen,
                      per_layer=[m["name"] for m in cell["per_layer"]])))
""" % (TINY, TINY_TRAFFIC, CPU_RATES)


@pytest.fixture(scope="module")
def tiny_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CELL_RUN], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_tiny_cell_is_correct(tiny_run):
    got, err = tiny_run
    res = got["result"]
    assert res is not None and res["correct"], res and res["checks"]
    assert set(res["checks"]) == {"color_gap", "alpha_gap", "depth_gap", "normal_gap",
                                  "surf_normal_gap"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "check surf_normal_gap:" in err and "K4 launches per frame" in err


def test_tiny_traced_run_reads_every_layer(tiny_run):
    got, _ = tiny_run
    metrics = got["result"]["metrics"]
    new = {"k4_roofline_pct.render2d", "surfel_cull_ms.render2d", "surfel_maps_ms.render2d",
           "host_syncs.render", "sync_wait_ms.render"}
    assert new <= set(got["per_layer"]) and len(got["per_layer"]) == 14
    # the sync spans open on the CPU too: the background, the key total, the
    # camera's inverse
    assert metrics["host_syncs.render"]["value"] == 3.0
    # no kernel runs on the CPU, so K4's roofline has nothing to read; the
    # eval path writes the cull ellipses in its fused preprocess and opens
    # no raster.surfel_cull span, so its reader is silent too
    silent = {"surfel_cull_ms.render2d"}
    for name in got["per_layer"]:
        if "roofline" in name or name in silent:
            assert name not in metrics
        else:
            assert isinstance(metrics[name]["value"], float), name


def test_tiny_traced_units_are_the_traced_frames(tiny_run):
    got, _ = tiny_run
    assert got["seen"] == [dict(traced_units=TINY_TRAFFIC["traced_units"],
                                frames=TINY_TRAFFIC["traced_units"])]


def test_tiny_run_loads_no_jax(tiny_run):
    got, _ = tiny_run
    assert got["forbidden"] == []


# the spans the cell's readers read

def _spans_of(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]


def test_new_spans_recorded_under_a_profiler():
    """The eval frame opens `render.surfel_maps`; `raster.surfel_cull` only
    where autograd records the plain stages (the eval path's fused surfel
    preprocess writes the ellipses inside `raster.preprocess`)."""
    params, alive = _scene(3, n=100)
    names = _spans_of(lambda: _program_maps(params, alive))
    assert names.count("render.surfel_maps") == 1
    assert names.count("raster.surfel_cull") == 0
    state = state_from_numpy(params, alive, device="cpu")
    state.params["xyz"].requires_grad_(True)
    cam = make_camera(POSE["R"], POSE["T"], POSE["fovx"], POSE["fovy"], W, H, device="cpu")
    names = _spans_of(lambda: render2d(cam, state, np.zeros(3, np.float32), sh_degree=3))
    for span in NEW_SPANS:
        assert names.count(span) == 1, span


def test_new_spans_are_no_ops_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert all(trace.span(s) is trace._OFF for s in NEW_SPANS)


# the new readers and K4's work model on hand-made inputs

def _reader(name):
    path = os.path.join(ROOT, "bench_port", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _label(count, busy_s):
    return dict(count=count, host_s=2 * busy_s, device_span_s=1.5 * busy_s, device_busy_s=busy_s)


@pytest.mark.parametrize("name,span", [("surfel_cull_ms.render2d", "raster.surfel_cull"),
                                       ("surfel_maps_ms.render2d", "render.surfel_maps")])
def test_span_readers(name, span):
    labels = {"unit.render": _label(20, 0.0), span: _label(20, 0.006)}
    ctx = dict(loop="render", profile=dict(labels=labels))
    assert _reader(name).read(ctx) == pytest.approx(1e3 * 0.006 / 20)
    # a program that opens no such span: the reader is silent
    unspanned = dict(ctx, profile=dict(labels={"unit.render": labels["unit.render"]}))
    assert _reader(name).read(unspanned) is None
    assert _reader(name).read(dict(ctx, loop="train")) is None


def test_k4_roofline_reader():
    kernels = [["void (anonymous namespace)::surfel_composite_kernel<false>(float const*)", 0.004],
               ["void (anonymous namespace)::composite_kernel(float const*)", 0.5]]
    ctx = dict(loop="render", primitive="2dgs", least_s={"surfel_composite_eval": 0.001},
               profile=dict(kernels=kernels))
    read = _reader("k4_roofline_pct.render2d").read
    assert read(ctx) == pytest.approx(25.0)
    assert read(dict(ctx, primitive="3dgs")) is None
    assert read(dict(ctx, profile=dict(kernels=kernels[1:]))) is None


def test_k4_work_counts():
    from bench_port import harness

    shape = dict(rows=2, param_floats=58, sh_coeffs=16, pixels=512, tiles=2, keys=3, pairs=768,
                 train=False)
    c = harness.work_part("surfel_composite_eval").cost(shape)
    assert (c["flops"], c["bytes"]) == (42 * 768, 84 * 3 + 8 * 2 + 40 * 512)
