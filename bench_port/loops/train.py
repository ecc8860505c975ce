"""The training loop: trainer iterations of the program, one view a step,
in a closed loop.

One iteration is the body of `scorp_tpu_torch/apps/train_3dgs.py:training`
(lines 345-399), in its order: `CameraSampler.next`, the background draw,
`GtDeviceCache.get`, `train_step` (or `train_step_2d`), `densify_round`,
the read of the dropped keys and `regrow_config`. The program has no
callable for one iteration, so the body is copied here; the evaluation,
saving, viewer and logging branches of the loop do not fire in the
window's iterations and are left out.

Set-up: the capture on disk (room.py), the program's `Scene` over it, the
state at the traffic's `start_iteration` (room.state_tensors), warm-up
iterations from that state whose results are dropped (they build and load
every kernel and grow the raster capacities as the trainer would have
before), then the checked iterations: the traffic's `checked_steps`
iterations from the same state, whose losses, first gradient (from Adam's
first moments) and parameter change are kept for the check; the window
goes on from the state they leave.
"""

from __future__ import annotations

import math
import os
import random
from argparse import Namespace

import numpy as np

from .. import room
from ..devtrace import clock, dispatched_ops, host_note, host_probe, labels, traced

BETA1 = 0.9
# an iteration's phases on the host's clock: the view's image, the step's
# dispatch, the densify round, the read of the dropped keys (the device's
# tail: the step's one wait on the device)
PHASES = ("gt", "step", "densify", "sync")


def _program(primitive: str):
    from scorp_tpu_torch.apps.train_3dgs import CameraSampler, GtDeviceCache, densify_round
    from scorp_tpu_torch.render import regrow_config, tuned_raster_config
    from scorp_tpu_torch.scene import Scene
    from scorp_tpu_torch.train import (AdamState, GaussianState, Opt2DParams, OptParams,
                                       train_step, train_step_2d)

    step, params_cls = (train_step_2d, Opt2DParams) if primitive == "2dgs" else (train_step, OptParams)
    return Namespace(CameraSampler=CameraSampler, GtDeviceCache=GtDeviceCache,
                     densify_round=densify_round, regrow_config=regrow_config,
                     tuned_raster_config=tuned_raster_config, Scene=Scene, AdamState=AdamState,
                     GaussianState=GaussianState, step=step, params_cls=params_cls)


def quarters(stamps: list) -> list:
    """Mean ms per unit in each quarter of the window, from the units' end
    times (seconds from its start): drift or a stall shows here."""
    out, lo = [], 0.0
    for q in (1, 2, 3, 4):
        hi = stamps[-1] * q / 4
        inside = [t for t in stamps if lo < t <= hi]
        out.append(round(1e3 * (hi - lo) / len(inside), 3) if inside else None)
        lo = hi
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str,
        hooks: dict) -> dict:
    import torch

    cfg, traffic = cell["config"], cell["traffic"]
    prog = _program(cfg["primitive"])
    if "step" in hooks:
        prog.step = hooks["step"](prog.step)
    opt = prog.params_cls(**{k: v for k, v in cfg["optimization"].items()
                             if k in prog.params_cls.__dataclass_fields__})
    scene_dir = os.path.join(tmp, "scene")
    poses = {p["name"]: p for p in room.write_capture(scene_dir, cfg, device)}

    random.seed(seed)  # the Scene's shuffle and the sampler's draws
    scene = prog.Scene(Namespace(source_path=scene_dir, model_path=os.path.join(tmp, "model"),
                                 images="images", resolution=-1, eval=True,
                                 split_yml_name="split.yml", white_background=False),
                       load_gaussians=False, max_sh_degree=cfg["sh_degree"])
    train_cams = scene.get_train_cameras()
    params, v, alive, cap = room.state_tensors(cfg, seed, device)
    start = int(traffic["start_iteration"])
    zeros = torch.zeros(cap, device=device)
    state0 = prog.GaussianState(params, alive, zeros, zeros.clone(), zeros.clone())
    adam0 = prog.AdamState({k: torch.zeros_like(p) for k, p in params.items()}, v, start - 1)

    sampler = prog.CameraSampler(train_cams)
    gt_cache = prog.GtDeviceCache(train_cams, device)
    bg_rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    bg_fixed = np.zeros(3, np.float32)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    loop = dict(cfg=prog.tuned_raster_config(cap), gt_wait=0.0, dropped=0,
                phase=dict.fromkeys(PHASES, 0.0))

    label = labels(trace)

    def iteration(state, adam, it):
        """One trainer iteration -> (state, adam, metrics, view name, bg)."""
        with label("unit.gt_fetch"):
            t = clock()
            cam, gt = sampler.next()
            bg = bg_rng.uniform(size=3).astype(np.float32) if opt.random_background else bg_fixed
            gt_img, gt_dcam, gt_dest = gt_cache.get(cam, gt)
            loop["gt_wait"] = clock() - t
        t1 = clock()
        with label("unit.step"):
            state, adam, metrics = prog.step(
                state, adam, cam.to_torch(device), gt_img, gt_dcam, gt_dest, it,
                torch.as_tensor(bg, device=device), opt=opt, sh_degree=cfg["sh_degree"],
                cfg=loop["cfg"], has_depth_cam=gt.depth_cam is not None,
                has_depth_est=gt.depth_est is not None)
        t2 = clock()
        with label("unit.densify"):
            state, adam = prog.densify_round(state, adam, gen, it, opt, scene.cameras_extent,
                                             False)
        t3 = clock()
        with label("unit.dropped_keys"):
            dropped = int(metrics.num_dropped_keys)
        t4 = clock()
        for k, d in zip(PHASES, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            loop["phase"][k] += d
        loop["dropped"] = dropped
        if dropped > 0:
            loop["cfg"] = prog.regrow_config(loop["cfg"], dropped)
        return state, adam, metrics, cam.image_name, bg

    # warm-up from the start state, results dropped, until two clean iterations
    clean, warm = 0, 0
    while clean < 2 or warm < int(traffic["warmup_iterations"]):
        iteration(state0, adam0, start)
        clean = clean + 1 if loop["dropped"] == 0 else 0
        warm += 1
        if warm > 50:
            raise RuntimeError("the raster capacities did not settle in 50 warm-up iterations")
    sync(device)

    # the checked iterations, through the window's own call
    steps, losses = [], []
    state, adam = state0, adam0
    first_grad_rows = None
    for i in range(int(traffic["checked_steps"])):
        it = start + i
        state, adam, metrics, name, bg = iteration(state, adam, it)
        losses.append(float(metrics.loss))
        if loop["dropped"]:
            raise RuntimeError(f"checked iteration {it} dropped {loop['dropped']} keys")
        steps.append(dict(name=name, bg=bg.tolist(), iteration=it))
        if i == 0:
            first_grad_rows = {k: (m / (1.0 - BETA1)).cpu() for k, m in adam.m.items()}
    change_rows = {k: (state.params[k] - params[k]).cpu() for k in params}
    first_grad, change = _norms(first_grad_rows), _norms(change_rows)
    del state0, adam0, params, v
    it = start + len(steps)

    # the window
    sync(device)
    setup_s = __import__("time").time() - t0
    gt_waits = []
    loop["phase"] = dict.fromkeys(PHASES, 0.0)
    probe = host_probe({"sampler": sampler.thread.native_id})
    w0 = clock()
    n = 0
    stamps = []
    while True:
        state, adam, _, _, _ = iteration(state, adam, it)
        gt_waits.append(loop["gt_wait"])
        it += 1
        n += 1
        stamps.append(clock() - w0)
        if stamps[-1] >= seconds:
            break
    sync(device)
    window_s = clock() - w0
    host = host_note(probe, host_probe({"sampler": sampler.thread.native_id}), n)
    phases = {k: round(1e3 * v / n, 3) for k, v in loop["phase"].items()}
    out = dict(attempted=n, failed=0, steps=steps, losses=losses, first_grad=first_grad,
               change=change, first_grad_rows=first_grad_rows, change_rows=change_rows,
               poses=poses, scene_dir=scene_dir, window_s=window_s,
               end_to_end={"setup_s": setup_s, "train_step_ms": 1e3 * window_s / n},
               gt_wait_s=gt_waits, units=n, notes=[])
    if trace:
        traced_units = []
        holder = dict(state=state, adam=adam, it=it)

        def unit():
            holder["state"], holder["adam"], _, name, bg = iteration(
                holder["state"], holder["adam"], holder["it"])
            traced_units.append(dict(name=name, bg=bg.tolist()))
            holder["it"] += 1

        out["profile"] = traced(unit, int(traffic["traced_units"]), "unit.window", device)
        out["traced"] = list(traced_units)
        counts = [dispatched_ops(unit) for _ in range(int(traffic["counted_units"]))]
        out["host_ops"] = sum(counts) / len(counts)
        state, adam = holder["state"], holder["adam"]
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["notes"].append(f"window {window_s:.3f} s, {n} iterations from {start + len(steps)}; "
                        f"gt wait mean {1e3 * sum(gt_waits) / n:.3f} ms; cfg {loop['cfg']}; "
                        f"ms per iteration by quarter of the window {quarters(stamps)}; "
                        f"host ms per iteration by phase {phases}")
    out["notes"].append(host)
    sampler.close()
    del state, adam, gt_cache
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def follow_reference(cell: dict, seed: int, out: dict, device, dtype=None) -> dict:
    """The reference's readings of the run's checked iterations, from the
    start state made again from the seed (`dtype`: the blend's precision)."""
    import torch

    from ..reference import train as ref_train

    cfg = cell["config"]
    params, v, alive, _ = room.state_tensors(cfg, seed, device)
    steps = [dict(pose=out["poses"][s["name"]], bg=s["bg"], iteration=s["iteration"],
                  image_path=os.path.join(out["scene_dir"], "images", s["name"] + ".jpg"))
             for s in out["steps"]]
    start = dict(params=params, v=v, alive=alive, step=int(cell["traffic"]["start_iteration"]) - 1)
    return ref_train.follow(start, steps, cfg, device, dtype or torch.float32)


def check(cell: dict, seed: int, out: dict, device, floors=()) -> dict:
    """The reference follows the checked iterations from the same start ->
    the numbers of `compare` (limits/<workload>.json says which count), and
    for each of `floors` the facing gaps at that floor (for calibrate.py)."""
    ref = follow_reference(cell, seed, out, device)
    got = compare(out, ref, cell["limits"].get("edge_on_cos_below"))
    for f in floors:
        got.update({f"{k}@{f:g}": v for k, v in facing_gaps(out, ref, f).items()})
    return got


def control(cell: dict, seed: int, out: dict, device, floors=()) -> tuple[dict, dict]:
    """(the control's readings: the reference with its blend in bfloat16 in
    the program's place, the program's readings) of one run."""
    import torch

    ref = follow_reference(cell, seed, out, device)
    low = follow_reference(cell, seed, out, device, torch.bfloat16)
    as_prog = dict(losses=low["losses"], first_grad=low["grad_norms"], change=low["change_norms"],
                   first_grad_rows=low["grad_rows"], change_rows=low["change_rows"])
    floor = cell["limits"].get("edge_on_cos_below")
    got = compare(as_prog, ref, floor), compare(out, ref, floor)
    for f in floors:
        for g, side in zip(got, (as_prog, out)):
            g.update({f"{k}@{f:g}": v for k, v in facing_gaps(side, ref, f).items()})
    return got


def _gaps(prog: dict, ref: dict, kept: list) -> list:
    """|program - reference| of each kept group's norm over the larger of
    its reference norm and the median kept group's."""
    med = float(np.median([ref[k] for k in kept]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept]


def _kept(grad_norms: dict) -> list:
    """The groups whose reference gradient is 1e-3 of the median group's or
    more: under that a group moves by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k in grad_norms if grad_norms[k] >= 1e-3 * med]


def compare(prog: dict, ref: dict, floor: float | None = None) -> dict:
    """The numbers a training cell can compare: the worst relative gap of a
    step's loss (`loss_gap`), and the worst group's gap (as `_gaps`) of its
    gradient norm at the first step and of its change norm after the last
    (`grad_gap`, `change_gap`); with a `floor`, for surfels, the same over
    the rows that face the camera (`grad_gap_facing`, `change_gap_facing`:
    see facing_gaps). The cell's limits file says which count."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    kept = _kept(ref["grad_norms"])
    out = {"loss_gap": loss_gap,
           "grad_gap": max(_gaps(prog["first_grad"], ref["grad_norms"], kept)),
           "change_gap": max(_gaps(prog["change"], ref["change_norms"], kept))}
    if floor is not None and ref.get("cos_first") is not None:
        out.update(facing_gaps(prog, ref, floor))
    return out


def facing_gaps(prog: dict, ref: dict, floor: float) -> dict:
    """The worst group's gradient and change gaps (as `_gaps`) over the rows
    that the reference sees at |cos| of ray and normal >= `floor`: in the
    first step's view for the gradient, in every step's view for the
    change. Rows seen edge-on are left out by that rule, taken from the
    reference's own tensors."""
    def norms(rows: dict, mask) -> dict:
        return {k: float(v.double()[mask.to(v.device)].norm()) for k, v in rows.items()}

    first, least = ref["cos_first"] >= floor, ref["cos_least"] >= floor
    r_g = norms(ref["grad_rows"], first)
    kept = _kept(r_g)
    g = _gaps(norms(prog["first_grad_rows"], first), r_g, kept)
    c = _gaps(norms(prog["change_rows"], least), norms(ref["change_rows"], least), kept)
    return {"grad_gap_facing": max(g), "change_gap_facing": max(c)}


def trace_context(cell: dict, seed: int, out: dict, device, rates: dict) -> dict:
    """What the per-layer readers read: the window, the profile, the host
    ops per iteration and the work model's least seconds of the traced
    iterations (their pairs and keys from the reference's render of each
    traced view at the start state)."""
    import torch

    from .. import harness
    from ..reference import camera, raster_of

    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, seed, device)
    parts = cfg["work"]["train"]
    least = {p: 0.0 for p in parts}
    for u in out["traced"]:
        cam = camera.camera(out["poses"][u["name"]], cfg["width"], cfg["height"], device)
        frame = raster_of(cfg["primitive"]).render(
            params, alive, cam, torch.as_tensor(np.asarray(u["bg"], np.float32), device=device))
        shape = work_shape(cfg, int(alive.sum()), frame, train=True)
        for p, s in harness.least_seconds(parts, shape, rates).items():
            least[p] += s
    units = len(out["traced"])
    return dict(loop="train", primitive=cfg["primitive"], profile=out["profile"],
                least_s=least, traced_units=units, window_s=out["window_s"], units=out["units"],
                gt_wait_s=out["gt_wait_s"], host_ops=out["host_ops"])


def work_shape(cfg: dict, n_alive: int, frame, train: bool) -> dict:
    k_sh = (cfg["sh_degree"] + 1) ** 2
    per_row = 3 + 3 * k_sh + cfg["scale_columns"] + 4 + 1
    return dict(rows=n_alive, param_floats=per_row, sh_coeffs=k_sh,
                pixels=cfg["width"] * cfg["height"],
                tiles=math.ceil(cfg["width"] / 16) * math.ceil(cfg["height"] / 16),
                keys=frame.keys, pairs=frame.pairs, train=train)
