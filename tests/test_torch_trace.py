"""The program's spans (scorp_tpu_torch/utils/trace.py) on the CPU: which
spans a render, a training step and a densification round record under
torch.profiler, how they nest, that they cost nothing without a profiler,
and the benchmark's readers of them (bench_port/metrics/)."""

import importlib.util
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from scorp_tpu_torch.apps.train_3dgs import densify_round
from scorp_tpu_torch.core.camera import look_at_camera
from scorp_tpu_torch.render import render, tuned_raster_config
from scorp_tpu_torch.render2d import render2d
from scorp_tpu_torch.train import (Opt2DParams, OptParams, init_adam, state_from_numpy,
                                   train_step, train_step_2d)
from scorp_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 300

RASTER = ["raster.preprocess", "raster.route", "raster.route.depth_order",
          "raster.route.expand", "raster.route.sort", "raster.gather", "raster.composite"]
STEP = ["step.forward", "step.loss", "step.backward", "step.update", "raster.backward"]
EXPECTED = {
    "render": {"render": 1, **dict.fromkeys(RASTER, 1)},
    "render2d": {"render": 1, **dict.fromkeys(RASTER, 1)},
    "train_step": {**dict.fromkeys(RASTER, 1), **dict.fromkeys(STEP, 1)},
    "train_step_2d": {**dict.fromkeys(RASTER, 1), **dict.fromkeys(STEP, 1)},
}
PROGRAM = ("render", "raster.", "step.", "densify.")


def _state(surfel: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    params = dict(
        xyz=rng.uniform(-1, 1, (N, 3)), f_dc=rng.normal(0, 0.5, (N, 1, 3)),
        f_rest=rng.normal(0, 0.05, (N, 15, 3)),
        scaling=np.log(rng.uniform(0.03, 0.1, (N, 2 if surfel else 3))),
        rotation=rng.normal(size=(N, 4)), opacity=rng.normal(0, 1, (N, 1)))
    return state_from_numpy(params, np.ones(N, bool), device="cpu")


def _call(what: str):
    """A no-argument call of one program entry at a tiny size."""
    cam = look_at_camera([0, 0, -4], [0, 0, 0], [0, -1, 0], 0.8, 0.6, W, H, device="cpu")
    surfel = what in ("render2d", "train_step_2d")
    state = _state(surfel)
    bg = torch.zeros(3)
    gt = torch.rand(3, H, W, generator=torch.Generator().manual_seed(1))
    z = torch.zeros(1, H, W)
    cfg = tuned_raster_config(N)
    return {
        "render": lambda: render(cam, state, bg, sh_degree=3),
        "render2d": lambda: render2d(cam, state, bg, sh_degree=3),
        "train_step": lambda: train_step(state, init_adam(state), cam, gt, z, z, 1000, bg,
                                         opt=OptParams(), sh_degree=3, cfg=cfg),
        "train_step_2d": lambda: train_step_2d(
            state, init_adam(state), cam, gt, z, z, 8000, bg,
            opt=Opt2DParams(lambda_dist=100.0), sh_degree=3, cfg=cfg),
    }[what]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events()
            if e.device_type != DeviceType.CUDA and e.name.startswith(PROGRAM)]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("what", sorted(EXPECTED))
def test_every_span_recorded_once(what):
    events = _profiled(_call(what))
    assert dict(Counter(e.name for e in events)) == EXPECTED[what]
    assert all(e.is_user_annotation for e in events)


@pytest.mark.parametrize("what", ["render", "train_step_2d"])
def test_children_inside_their_parent(what):
    events = _profiled(_call(what))
    by_name = {e.name: e for e in events}
    parents = {"raster.route.depth_order": "raster.route", "raster.route.expand": "raster.route",
               "raster.route.sort": "raster.route"}
    outer = "render" if what == "render" else "step.forward"
    for name in RASTER:
        parents.setdefault(name, outer)
    if what == "train_step_2d":
        parents.update({"step.loss": "step.forward", "raster.backward": "step.backward"})
    for child, parent in parents.items():
        c, p = by_name[child].time_range, by_name[parent].time_range
        assert p.start <= c.start and c.end <= p.end, (child, parent)
    # the step's three parts follow one another
    if what == "train_step_2d":
        f, b, u = (by_name[n].time_range for n in ("step.forward", "step.backward", "step.update"))
        assert f.end <= b.start and b.end <= u.start


def test_backward_span_is_recorded_from_autograd():
    """`raster.backward` opens inside the backward of the rasterizer's
    autograd Function: under torch.autograd.grad, not in the forward."""
    cam = look_at_camera([0, 0, -4], [0, 0, 0], [0, -1, 0], 0.8, 0.6, W, H, device="cpu")
    state = _state(False)
    from scorp_tpu_torch.ops.raster import rasterize

    xyz = state.params["xyz"].clone().requires_grad_(True)

    def forward_only():
        return rasterize(xyz, torch.sigmoid(state.params["opacity"][:, 0]), cam, torch.zeros(3),
                         colors_precomp=torch.rand(N, 3), scales=torch.exp(state.params["scaling"]),
                         quats=state.params["rotation"], cfg=tuned_raster_config(N))

    assert "raster.backward" not in {e.name for e in _profiled(forward_only)}
    out = forward_only()
    events = _profiled(lambda: torch.autograd.grad(out.color.sum(), xyz))
    assert [e.name for e in events] == ["raster.backward"]


def test_densify_round_span_when_a_round_fires():
    state = _state(False)
    state = state._replace(xyz_grad_accum=torch.full((N,), 1e-2), denom=torch.ones(N))
    adam = init_adam(state)
    opt = OptParams()

    def at(iteration):
        return lambda: densify_round(state, adam, torch.Generator().manual_seed(0), iteration,
                                     opt, 1.0, False)

    fired = _profiled(at(opt.densify_from_iter + opt.densification_interval))
    assert [e.name for e in fired] == ["densify.round"]
    assert _profiled(at(opt.densify_from_iter + opt.densification_interval + 1)) == []


def test_off_without_a_profiler():
    """No profiler: every span is the one shared no-op, and a profile taken
    later holds nothing of the calls made before it."""
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("render") is trace.span("raster.route") is trace._OFF
    fn = _call("render")
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.zeros(1).add_(1)
    assert not [e for e in prof.events() if e.name.startswith(PROGRAM)]
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("render") is not trace._OFF


# the benchmark's readers of the spans, on a hand-made traced run

def _reader(name):
    path = os.path.join(ROOT, "bench_port", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _label(count, host_s, busy_s):
    return dict(count=count, host_s=host_s, device_span_s=busy_s * 1.5, device_busy_s=busy_s)


FRAMES = 20
LABELS = {
    "unit.render": _label(FRAMES, 0.30, 0.0),
    "render": _label(FRAMES, 0.24, 0.20),
    "raster.preprocess": _label(FRAMES, 0.16, 0.07),
    "raster.route": _label(FRAMES, 0.03, 0.06),
    "raster.route.depth_order": _label(FRAMES, 0.005, 0.002),
    "raster.route.sort": _label(FRAMES, 0.004, 0.024),
    "raster.gather": _label(FRAMES, 0.008, 0.04),
}
READS = {  # reader -> ms a frame from LABELS
    "preprocess_ms.render": 1e3 * 0.07 / FRAMES,
    "routing_ms.render": 1e3 * (0.06 + 0.002) / FRAMES,
    "depth_order_ms.render": 1e3 * 0.002 / FRAMES,
    "key_sort_ms.render": 1e3 * 0.024 / FRAMES,
    "gather_ms.render": 1e3 * 0.04 / FRAMES,
    "render_dispatch_ms": 1e3 * 0.24 / FRAMES,
}
SPAN_OF = {"preprocess_ms.render": "raster.preprocess", "routing_ms.render": "raster.route",
           "depth_order_ms.render": "raster.route.depth_order",
           "key_sort_ms.render": "raster.route.sort", "gather_ms.render": "raster.gather",
           "render_dispatch_ms": "render"}


def _ctx(labels, loop="render"):
    # traced_units counts more frames than the profile holds: the readers
    # divide by the frames of the trace (the `unit.render` label)
    return dict(loop=loop, traced_units=FRAMES + 3, profile=dict(labels=labels))


@pytest.mark.parametrize("name", sorted(READS))
def test_span_reader_values(name):
    got = _reader(name).read(_ctx(LABELS))
    assert got == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
def test_span_reader_silent_without_its_span(name):
    labels = {k: v for k, v in LABELS.items() if k != SPAN_OF[name]}
    assert _reader(name).read(_ctx(labels)) is None
    assert _reader(name).read(_ctx(LABELS, loop="train")) is None
    assert _reader(name).read(dict(loop="render", traced_units=3, profile=dict(window_s=1.0))) \
        is None


def test_routing_reader_without_a_depth_order_span():
    labels = {k: v for k, v in LABELS.items() if k != "raster.route.depth_order"}
    assert _reader("routing_ms.render").read(_ctx(labels)) == pytest.approx(1e3 * 0.06 / FRAMES)
