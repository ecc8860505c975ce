"""The viewer loop: one client in a closed loop, each frame the program's
`render()` of the next pose and the copy of its image to host memory, as
`viewer/network_gui.py`'s `gui_render` hands a frame to the viewer. The
poses are the capture's, in an order drawn from the seed; the state is the
start state of the training cells of the same configuration.

Frames are timed from the call to the image in host memory. A sample of
the window's frames, drawn from the seed, keeps its image, depth and alpha
for the check.
"""

from __future__ import annotations

import time

import numpy as np

from .. import room
from ..devtrace import clock, dispatched_ops, host_note, host_probe, labels, traced
from .train import quarters, work_shape


def _program(primitive: str):
    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.render import render
    from scorp_tpu_torch.train import GaussianState

    if primitive != "3dgs":
        raise ValueError(f"the viewer loop renders 3dgs states, not {primitive}")
    return make_camera, render, GaussianState


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str,
        hooks: dict) -> dict:
    import torch

    cfg, traffic = cell["config"], cell["traffic"]
    make_camera, render, GaussianState = _program(cfg["primitive"])
    if "render" in hooks:
        render = hooks["render"](render)
    poses = room.poses(cfg)
    params, _, alive, cap = room.state_tensors(cfg, seed, device)
    zeros = torch.zeros(cap, device=device)
    state = GaussianState(params, alive, zeros, zeros.clone(), zeros.clone())
    cams = [make_camera(p["R"], p["T"], p["fovx"], p["fovy"], cfg["width"], cfg["height"],
                        device=device) for p in poses]
    bg = np.zeros(3, np.float32)
    order = np.random.default_rng(seed).permutation(len(poses))
    sample = set(np.random.default_rng(seed + 1).choice(
        int(traffic["sampled_from_first"]), int(traffic["sampled_frames"]), replace=False).tolist())
    pos = dict(i=0)

    label = labels(trace)

    def frame():
        view = int(order[pos["i"] % len(order)])
        with label("unit.render"):
            out = render(cams[view], state, bg, sh_degree=cfg["sh_degree"])
        with label("unit.to_host"):
            img = out["render"].cpu().numpy()
        pos["i"] += 1
        return view, out, img

    for _ in range(int(traffic["warmup_frames"])):
        frame()
    pos["i"] = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0

    lat, kept, stamps = [], [], []
    probe = host_probe()
    w0 = clock()
    while True:
        t = clock()
        view, out, img = frame()
        lat.append(clock() - t)
        stamps.append(clock() - w0)
        if len(lat) - 1 in sample:
            kept.append(dict(view=view, image=img, depth=out["render_depth"].clone(),
                             alpha=out["render_alpha"].clone()))
        if stamps[-1] >= seconds:
            break
    window_s = clock() - w0
    n = len(lat)
    host = host_note(probe, host_probe(), n)
    p95 = float(np.quantile(np.asarray(lat), 0.95, method="higher"))
    res = dict(attempted=n, failed=0, window_s=window_s, units=n, kept=kept, poses=poses,
               end_to_end={"setup_s": setup_s, "frame_ms": 1e3 * window_s / n,
                           "frame_p95_ms": 1e3 * p95},
               notes=[f"window {window_s:.3f} s, {n} frames, median "
                      f"{1e3 * float(np.median(lat)):.3f} ms; ms per frame by quarter of the "
                      f"window {quarters(stamps)}", host])
    # sampled frames the window did not reach come late, not wrong
    while len(kept) < len(sample):
        idx = sorted(sample)[len(kept)]
        pos["i"] = idx
        view, out, img = frame()
        kept.append(dict(view=view, image=img, depth=out["render_depth"].clone(),
                         alpha=out["render_alpha"].clone()))
    if trace:
        traced_views = []

        def unit():
            view, _, _ = frame()
            traced_views.append(view)

        res["profile"] = traced(unit, int(traffic["traced_units"]), "unit.window", device)
        res["traced"] = traced_views
        counts = [dispatched_ops(unit) for _ in range(int(traffic["counted_units"]))]
        res["host_ops"] = sum(counts) / len(counts)
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del state, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def check(cell: dict, seed: int, out: dict, device) -> dict:
    """The reference renders each sampled frame's pose from the same state
    -> the worst frame's mean |difference| of colour and alpha, and of depth
    over the reference's mean depth."""
    return gaps(cell, seed, out["kept"], out["poses"], device)


def gaps(cell: dict, seed: int, kept: list, poses: list, device, dtype=None) -> dict:
    import torch

    from ..reference import camera, raster_of

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    bg = torch.zeros(3, device=device)
    out = dict(color_gap=0.0, alpha_gap=0.0, depth_gap=0.0)
    for k in kept:
        cam = camera.camera(poses[k["view"]], cfg["width"], cfg["height"], device)
        ref = raster_of(cfg["primitive"]).render(params, alive, cam, bg)
        a = ref.alpha
        depth = torch.where(a > 0, ref.depth / torch.where(a > 0, a, 1.0), 0.0)
        img = torch.as_tensor(k["image"], device=device)
        out["color_gap"] = max(out["color_gap"], float((img - ref.color).abs().mean()))
        out["alpha_gap"] = max(out["alpha_gap"], float((k["alpha"] - a).abs().mean()))
        out["depth_gap"] = max(out["depth_gap"], float((k["depth"] - depth).abs().mean()
                                                       / depth.mean().clamp_min(1e-12)))
    return out


def control(cell: dict, seed: int, out: dict, device) -> tuple[dict, dict]:
    """(the control's readings: the reference's frames with the blend in
    bfloat16 in the program's place, the program's readings) of one run."""
    import torch

    from ..reference import camera, raster_of

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    low = []
    for k in out["kept"]:
        cam = camera.camera(out["poses"][k["view"]], cfg["width"], cfg["height"], device)
        f = raster_of(cfg["primitive"]).render(params, alive, cam, torch.zeros(3, device=device),
                                               dtype=torch.bfloat16)
        a = f.alpha
        low.append(dict(view=k["view"], image=f.color, alpha=a,
                        depth=torch.where(a > 0, f.depth / torch.where(a > 0, a, 1.0), 0.0)))
    del params
    return gaps(cell, seed, low, out["poses"], device), check(cell, seed, out, device)


def trace_context(cell: dict, seed: int, out: dict, device, rates: dict) -> dict:
    import torch

    from .. import harness
    from ..reference import camera, raster_of

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    parts = cfg["work"]["render"]
    least = {p: 0.0 for p in parts}
    bg = torch.zeros(3, device=device)
    for view in out["traced"]:
        cam = camera.camera(out["poses"][view], cfg["width"], cfg["height"], device)
        frame = raster_of(cfg["primitive"]).render(params, alive, cam, bg)
        shape = work_shape(cfg, int(alive.sum()), frame, train=False)
        for p, s in harness.least_seconds(parts, shape, rates).items():
            least[p] += s
    return dict(loop="render", primitive=cfg["primitive"], profile=out["profile"],
                least_s=least, traced_units=len(out["traced"]), window_s=out["window_s"],
                units=out["units"], host_ops=out["host_ops"])
