"""The program's spans (scorp_tpu_torch/utils/trace.py) on the CPU: which
spans a render, a training step and a densification round record under
torch.profiler, how they nest, that the `sync.*` spans are leaves and that
a fusion or a host triangulation opens none, that they cost nothing
without a profiler, and the benchmark's readers of them
(bench_port/metrics/). On the card (marked `cuda`, skipped elsewhere):
every host wait that torch.cuda.set_sync_debug_mode("warn") reports in a
render, a 2DGS render, a fusion and a contracted triangulation lies in a
`sync.*` span of the program, one wait a span. On a GPU machine:

    python -m pytest tests/test_torch_trace.py -q -m cuda
"""

import importlib.util
import os
import traceback
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from scorp_tpu_torch.apps.train_3dgs import densify_round
from scorp_tpu_torch.core.camera import look_at_camera
from scorp_tpu_torch.render import render, tuned_raster_config
from scorp_tpu_torch.render2d import render2d
from scorp_tpu_torch.train import (Opt2DParams, OptParams, init_adam, state_from_numpy,
                                   train_step, train_step_2d)
from scorp_tpu_torch.utils import trace
# the fusion tests' analytic maps and grids (pytest puts tests/ on the path)
from test_torch_tsdf_fuse import _card_views, _card_volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 64, 48, 300

RASTER = ["raster.preprocess", "raster.route", "raster.route.depth_order",
          "raster.route.expand", "raster.route.sort", "raster.gather", "raster.composite"]
STEP = ["step.forward", "step.loss", "step.backward", "step.update", "raster.backward"]
# the host waits of a render: the background's upload and the routing's
# read of the key total; 2DGS adds the camera's inverse in depth_to_normal
SYNC = {"sync.bg_upload": 1, "sync.route_total": 1}
EXPECTED = {
    "render": {"render": 1, **dict.fromkeys(RASTER, 1), **SYNC},
    # the eval path's fused surfel preprocess writes the cull ellipses inside
    # raster.preprocess; only the grad path opens raster.surfel_cull
    "render2d": {"render": 1, "render.surfel_maps": 1, **dict.fromkeys(RASTER, 1), **SYNC,
                 "sync.camera_inverse": 1},
    "train_step": {**dict.fromkeys(RASTER, 1), **dict.fromkeys(STEP, 1), "sync.route_total": 1},
    "train_step_2d": {"raster.surfel_cull": 1, **dict.fromkeys(RASTER, 1),
                      **dict.fromkeys(STEP, 1), "sync.route_total": 1,
                      "sync.camera_inverse": 1},
}
PROGRAM = ("render", "raster.", "step.", "densify.", "mesh.", "sync.")


def _state(surfel: bool, seed: int = 0, device="cpu"):
    rng = np.random.default_rng(seed)
    params = dict(
        xyz=rng.uniform(-1, 1, (N, 3)), f_dc=rng.normal(0, 0.5, (N, 1, 3)),
        f_rest=rng.normal(0, 0.05, (N, 15, 3)),
        scaling=np.log(rng.uniform(0.03, 0.1, (N, 2 if surfel else 3))),
        rotation=rng.normal(size=(N, 4)), opacity=rng.normal(0, 1, (N, 1)))
    return state_from_numpy(params, np.ones(N, bool), device=device)


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


@pytest.mark.parametrize("what", ["render", "render2d", "train_step_2d"])
def test_children_inside_their_parent(what):
    events = _profiled(_call(what))
    by_name = {e.name: e for e in events}
    parents = {"raster.route.depth_order": "raster.route", "raster.route.expand": "raster.route",
               "raster.route.sort": "raster.route"}
    outer = "step.forward" if what == "train_step_2d" else "render"
    for name in RASTER + (["raster.surfel_cull"] if what == "train_step_2d" else []):
        parents.setdefault(name, outer)
    parents["sync.route_total"] = "raster.route"
    if what != "train_step_2d":
        parents["sync.bg_upload"] = "render"
    if what == "render2d":
        parents.update({"render.surfel_maps": "render",
                        "sync.camera_inverse": "render.surfel_maps"})
    if what == "train_step_2d":
        parents.update({"step.loss": "step.forward", "raster.backward": "step.backward",
                        "sync.camera_inverse": "step.forward"})
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


@pytest.mark.parametrize("what", sorted(EXPECTED))
def test_sync_spans_are_leaves(what):
    """A `sync.*` span encloses only the statement that makes the host
    wait: no other span of the program opens inside it."""
    events = _profiled(_call(what))
    waits = [e.time_range for e in events if e.name.startswith("sync.")]
    assert waits
    for e in events:
        r = e.time_range
        if not e.name.startswith("sync."):
            assert not any(w.start <= r.start and r.end <= w.end for w in waits), e.name


def _mesh_call(what: str, dev, res: int = 32):
    """One view's fusion into a contracted grid, or the triangulation of a
    contracted grid three analytic views fused, as a no-argument call."""
    views = _card_views(dev)
    v = _card_volume("contracted", res, dev)
    if what == "integrate":
        depth, color, cam = views[0]
        return lambda: v.integrate(depth, color, cam)
    for depth, color, cam in views:
        v.integrate(depth, color, cam)
    return v.triangulate


@pytest.mark.parametrize("what", ["integrate", "triangulate"])
def test_fusion_and_host_triangulation_open_no_sync_span(what):
    """On the CPU a view's fusion (the plain update) and the host's marching
    cubes wait for no device: each opens its `mesh.*` span and no `sync.*`
    span (the triangulation's two waits are the card path's)."""
    names = Counter(e.name for e in _profiled(_mesh_call(what, torch.device("cpu"))))
    assert names == {"integrate": {"mesh.fuse": 1}, "triangulate": {"mesh.triangulate": 1}}[what]


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


# the host-wait readers (bench_port/metrics/_syncs.py): every `sync.*` label
# of the trace, over the loop's own unit label

EXTRACTS = 5
RENDER_WAITS = {
    "unit.render": _label(FRAMES, 0.30, 0.0),
    "render": _label(FRAMES, 0.24, 0.20),
    "sync.bg_upload": _label(FRAMES, 0.002, 0.0),
    "sync.route_total": _label(FRAMES, 0.024, 0.0),
    "sync.camera_inverse": _label(FRAMES, 0.031, 0.0004),
}
MESH_WAITS = {
    "unit.extract": _label(EXTRACTS, 0.07, 0.0),
    "mesh.triangulate": _label(EXTRACTS, 0.016, 0.023),
    "sync.mc_totals": _label(EXTRACTS, 0.0125, 0.0),
    "sync.mesh_copy": _label(EXTRACTS, 0.035, 0.0),
}
SYNC_READS = {  # reader -> (its loop, the labels, its reading)
    "host_syncs.render": ("render", RENDER_WAITS, 3.0),
    "sync_wait_ms.render": ("render", RENDER_WAITS, 1e3 * (0.002 + 0.024 + 0.031) / FRAMES),
    "host_syncs.mesh": ("extract2d", MESH_WAITS, 2.0),
    "sync_wait_ms.mesh": ("extract2d", MESH_WAITS, 1e3 * (0.0125 + 0.035) / EXTRACTS),
}


@pytest.mark.parametrize("name", sorted(SYNC_READS))
def test_sync_reader_values(name):
    loop, labels, want = SYNC_READS[name]
    assert _reader(name).read(_ctx(labels, loop)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(SYNC_READS))
def test_sync_reader_silent_outside_its_loop_and_without_sync_spans(name):
    """None in the other loops, in a trace of a program that opens no
    `sync.*` span, and in a trace without the loop's unit label."""
    loop, labels, _ = SYNC_READS[name]
    for other in ("render", "extract2d", "fuse2d", "train"):
        if other != loop:
            assert _reader(name).read(_ctx(labels, other)) is None, other
    no_waits = {k: v for k, v in labels.items() if not k.startswith("sync.")}
    assert _reader(name).read(_ctx(no_waits, loop)) is None
    no_units = {k: v for k, v in labels.items() if not k.startswith("unit.")}
    assert _reader(name).read(_ctx(no_units, loop)) is None


# ---------------------------------------------------------------- card

# the `sync.*` spans of one call on the card, by name
CARD = {"render": SYNC, "render2d": {**SYNC, "sync.camera_inverse": 1}, "integrate": {},
        "triangulate": {"sync.mc_totals": 1, "sync.mesh_copy": 1}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the host waits for the card)")
    return torch.device("cuda", 0)


def _card_call(what: str, dev):
    """One render, 2DGS render (with the viewer loops' host background and
    arguments), fusion or contracted triangulation on the card."""
    if what in ("integrate", "triangulate"):
        return _mesh_call(what, dev, 64)
    cam = look_at_camera([0, 0, -4], [0, 0, 0], [0, -1, 0], 0.8, 0.6, W, H, device=dev)
    state = _state(what == "render2d", device=dev)
    bg = np.zeros(3, np.float32)
    if what == "render":
        return lambda: render(cam, state, bg, sh_degree=3)
    return lambda: render2d(cam, state, bg, sh_degree=3, depth_ratio=1.0)


def host_waits(fn):
    """(waits, spans) of one call of fn() after a warm-up call. waits: for
    each host synchronisation that torch.cuda.set_sync_debug_mode("warn")
    reports, (the innermost span of the program open there or None, the
    innermost line of scorp_tpu_torch on the stack as "path:line").
    spans: the `sync.*` spans the call recorded under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    opened, waits = [], []

    class Tracked(record_function):  # keeps the names of the open spans
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            opened.pop()
            return super().__exit__(*exc)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            site = [f for f in traceback.extract_stack() if "scorp_tpu_torch" in f.filename]
            where = (f"{os.path.relpath(site[-1].filename, ROOT)}:{site[-1].lineno}" if site
                     else f"{filename}:{lineno}")
            waits.append((opened[-1] if opened else None, where))

    real = trace.record_function
    trace.record_function = Tracked
    try:
        with warnings.catch_warnings(), profile(activities=[ProfilerActivity.CPU]) as prof:
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.record_function = real
    spans = Counter(e.name for e in prof.events()
                    if e.device_type != DeviceType.CUDA and e.name.startswith("sync."))
    return waits, spans


@pytest.mark.cuda
@pytest.mark.parametrize("what", sorted(CARD))
def test_every_host_wait_lies_in_a_sync_span(dev, what):
    """Each host synchronisation of the call lies in a `sync.*` span, one a
    span: a new wait on these paths fails here until it is named. The
    fusion waits for nothing."""
    waits, spans = host_waits(_card_call(what, dev))
    assert all(s is not None and s.startswith("sync.") for s, _ in waits), waits
    assert Counter(s for s, _ in waits) == spans == CARD[what], waits
