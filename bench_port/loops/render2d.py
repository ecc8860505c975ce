"""The 2DGS viewer loop: one client in a closed loop, each frame the
program's `render2d()` of the next pose and the copy of its image to host
memory, as the surfel trainer's `--gui` (`viewer/network_gui.py:gui_tick`)
hands a frame to the viewer. The poses are the capture's, in an order drawn
from the seed; the state is the start state of the training cells of the
same configuration (2 scale columns).

Frames are timed from the call to the image in host memory. A sample of
the window's frames, drawn from the seed, keeps its image, alpha, depth
(`render_depth`), world normal and pseudo surface normal for the check.
The frame's work parts are the traffic's `work` list: the configuration's
`work` names the training parts only.
"""

from __future__ import annotations

import time

import numpy as np

from .. import room
from ..devtrace import clock, dispatched_ops, host_note, host_probe, labels, traced
from .train import quarters, work_shape

# render2d's default, as the viewer calls it: render_depth is the median
# depth, which the check compares
DEPTH_RATIO = 1.0
# the check's numbers -> the map each compares (the sampled frame's key)
GAPS = dict(color_gap="image", alpha_gap="alpha", depth_gap="depth", normal_gap="normal",
            surf_normal_gap="surf_normal")


def _program(primitive: str):
    from scorp_tpu_torch.core.camera import make_camera
    from scorp_tpu_torch.ops.raster.surfel_composite import surfel_composite
    from scorp_tpu_torch.render2d import render2d
    from scorp_tpu_torch.train import GaussianState

    if primitive != "2dgs":
        raise ValueError(f"the 2DGS viewer loop renders 2dgs states, not {primitive}")
    return make_camera, render2d, GaussianState, surfel_composite


def _kept(view: int, out: dict, img) -> dict:
    return dict(view=view, image=img, alpha=out["render_alpha"].clone(),
                depth=out["render_depth"].clone(), normal=out["render_normal"].clone(),
                surf_normal=out["surf_normal"].clone(),
                dropped=out["num_dropped_keys"].clone())


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str,
        hooks: dict) -> dict:
    import torch

    cfg, traffic = cell["config"], cell["traffic"]
    make_camera, render2d, GaussianState, k4 = _program(cfg["primitive"])
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
            out = render2d(cams[view], state, bg, sh_degree=cfg["sh_degree"],
                           depth_ratio=DEPTH_RATIO)
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
    launches0 = k4.launches
    w0 = clock()
    while True:
        t = clock()
        view, out, img = frame()
        lat.append(clock() - t)
        stamps.append(clock() - w0)
        if len(lat) - 1 in sample:
            kept.append(_kept(view, out, img))
        if stamps[-1] >= seconds:
            break
    window_s = clock() - w0
    n = len(lat)
    launches = (k4.launches - launches0) / n
    host = host_note(probe, host_probe(), n)
    p95 = float(np.quantile(np.asarray(lat), 0.95, method="higher"))
    res = dict(attempted=n, failed=0, window_s=window_s, units=n, kept=kept, poses=poses,
               end_to_end={"setup_s": setup_s, "frame_ms": 1e3 * window_s / n,
                           "frame_p95_ms": 1e3 * p95},
               notes=[f"window {window_s:.3f} s, {n} frames, median "
                      f"{1e3 * float(np.median(lat)):.3f} ms; ms per frame by quarter of the "
                      f"window {quarters(stamps)}",
                      f"K4 launches per frame {launches:.3f} (surfel_composite.launches)",
                      host])
    # sampled frames the window did not reach come late, not wrong
    while len(kept) < len(sample):
        pos["i"] = sorted(sample)[len(kept)]
        kept.append(_kept(*frame()))
    res["notes"].append("dropped keys in the sampled frames "
                        f"{[int(k.pop('dropped')) for k in kept]}")
    if trace:
        traced_views = []

        def unit():
            view, _, _ = frame()
            traced_views.append(view)

        res["profile"] = traced(unit, int(traffic["traced_units"]), "unit.window", device)
        res["traced"] = list(traced_views)  # the frames the profile holds, and no later ones
        counts = [dispatched_ops(unit) for _ in range(int(traffic["counted_units"]))]
        res["host_ops"] = sum(counts) / len(counts)
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del state, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def reference_maps(frame, cam: dict) -> dict:
    """The program's maps from a reference frame: alpha, the median depth
    (`render_depth` at depth_ratio 1), the weighted view normal rotated to
    world space, and the pseudo surface normal of the median depth times
    alpha."""
    from ..reference import raster2d

    # n_world = Rw^T n_view, elementwise: no matrix product that TF32 could take
    normal = (cam["view"][:3, :3][:, :, None, None] * frame.normal[:, None]).sum(0)
    return dict(alpha=frame.alpha, depth=frame.median, normal=normal,
                surf_normal=raster2d.depth_to_normal(cam, frame.median) * frame.alpha)


def check(cell: dict, seed: int, out: dict, device) -> dict:
    """The reference renders each sampled frame's pose from the same state
    -> the worst frame's mean |difference| of colour, alpha, world normal and
    pseudo surface normal, and of depth over the reference's mean depth."""
    return gaps(cell, seed, out["kept"], out["poses"], device)


def gaps(cell: dict, seed: int, kept: list, poses: list, device) -> dict:
    import torch

    from ..reference import camera, raster2d

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    bg = torch.zeros(3, device=device)
    out = dict.fromkeys(GAPS, 0.0)
    for k in kept:
        cam = camera.camera(poses[k["view"]], cfg["width"], cfg["height"], device)
        ref = raster2d.render(params, alive, cam, bg)
        want = dict(image=ref.color, **reference_maps(ref, cam))
        got = dict(k, image=torch.as_tensor(k["image"], device=device))
        mean_depth = float(want["depth"].mean().clamp_min(1e-12))
        for name, key in GAPS.items():
            gap = float((got[key] - want[key]).abs().mean())
            out[name] = max(out[name], gap / mean_depth if key == "depth" else gap)
    return out


def control(cell: dict, seed: int, out: dict, device) -> tuple[dict, dict]:
    """(the control's readings: the reference's frames with the blend in
    bfloat16 in the program's place, the program's readings) of one run."""
    import torch

    from ..reference import camera, raster2d

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    low = []
    for k in out["kept"]:
        cam = camera.camera(out["poses"][k["view"]], cfg["width"], cfg["height"], device)
        f = raster2d.render(params, alive, cam, torch.zeros(3, device=device),
                            dtype=torch.bfloat16)
        low.append(dict(view=k["view"], image=f.color, **reference_maps(f, cam)))
    del params
    return gaps(cell, seed, low, out["poses"], device), check(cell, seed, out, device)


def trace_context(cell: dict, seed: int, out: dict, device, rates: dict) -> dict:
    import torch

    from .. import harness
    from ..reference import camera, raster2d

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    parts = cell["traffic"]["work"]
    least = {p: 0.0 for p in parts}
    bg = torch.zeros(3, device=device)
    for view in out["traced"]:
        cam = camera.camera(out["poses"][view], cfg["width"], cfg["height"], device)
        frame = raster2d.render(params, alive, cam, bg)
        shape = work_shape(cfg, int(alive.sum()), frame, train=False)
        for p, s in harness.least_seconds(parts, shape, rates).items():
            least[p] += s
    # "render": the shared readers of the viewer's spans and frames apply
    return dict(loop="render", primitive=cfg["primitive"], profile=out["profile"],
                least_s=least, traced_units=len(out["traced"]), window_s=out["window_s"],
                units=out["units"], host_ops=out["host_ops"])
