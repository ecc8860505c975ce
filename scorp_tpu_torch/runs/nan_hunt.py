"""Densification-run NaN hunt, port of the JAX package's `scripts/nan_hunt.py`.

Trains the densification run's scene with the trainer's recipe
(`apps.train_3dgs.training`: its camera sampler, GT cache, seeds, background
draw, SH schedule, `densify_round` and raster regrow) plus checks that the
trainer cannot afford: the loss read back after every step, every parameter,
statistic and Adam moment checked every SNAP iterations, a two-deep ring of
state snapshots every SNAP iterations and a log of the last 2*SNAP + 1
steps' (camera, ground truth, background). As in the JAX script, the step
gets no depth maps (the densification scene has none). On the first
non-finite value it
rewinds to the older snapshot, replays step by step with full checks after
each step and each densification, and dumps the faulting step's exact
inputs to `<outdir>/fault_iter<N>.npz` (`fault_densify_iter<N>.npz` when the
densification made the first non-finite value). The dump has the JAX
script's keys, dtypes and shapes, so `runs.nan_replay` and the JAX
package's `scripts/nan_replay.py` read each other's dumps.

    python -m scorp_tpu_torch.runs.nan_hunt [outdir] [--iters N] [--device cuda]

On the card a step is not bit-reproducible (the backward compositor K3 sums
with atomics), so a fault is reached again by replaying from a snapshot,
not by re-running from the start. The scene is built once per outdir (kept
while `<outdir>/scene/split.yml` exists).
"""

from __future__ import annotations

import os
import random
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..core.camera import Camera
from ..device import resolve_device
from ..train import train_step
from ..train.state import STAT_KEYS

SNAP = 20  # iterations between snapshots and between full checks


def params_finite_report(state, adam=None) -> dict:
    """{name: count} of the non-finite values: rows with any non-finite entry
    for each parameter, entries for the statistics and, with `adam`, for
    each moment (`adam_m.<key>`, `adam_v.<key>`). Reduced on the device, with
    one read to the host."""
    names, counts = [], []
    for k, v in state.params.items():
        names.append(k)
        counts.append((~torch.isfinite(v)).reshape(v.shape[0], -1).any(dim=1).sum())
    for k in STAT_KEYS:
        names.append(k)
        counts.append((~torch.isfinite(getattr(state, k))).sum())
    if adam is not None:
        for prefix, moments in (("adam_m", adam.m), ("adam_v", adam.v)):
            for k, v in moments.items():
                names.append(f"{prefix}.{k}")
                counts.append((~torch.isfinite(v)).sum())
    return {k: n for k, n in zip(names, torch.stack(counts).tolist()) if n}


def read_step(metrics) -> tuple[float, int, int]:
    """(loss, alive rows, dropped keys) of a step's metrics, in one read to
    the host: the trainer's loop also reads once per step (the dropped
    keys)."""
    loss, alive, dropped = torch.cat([
        x.double().reshape(1) for x in (metrics.loss, metrics.num_alive, metrics.num_dropped_keys)
    ]).tolist()
    return loss, int(alive), int(dropped)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dump_step_inputs(path, state, adam, cam: Camera, bg, iteration: int, active_sh: int,
                     gt_img) -> None:
    """Write one step's inputs (the device camera `cam`, the [3] background,
    the [3,H,W] ground truth) with the JAX script's keys and dtypes."""
    payload = {f"param.{k}": _host(v) for k, v in state.params.items()}
    payload.update({f"adam_m.{k}": _host(v) for k, v in adam.m.items()})
    payload.update({f"adam_v.{k}": _host(v) for k, v in adam.v.items()})
    payload.update(
        alive=_host(state.alive),
        max_radii2d=_host(state.max_radii2d),
        xyz_grad_accum=_host(state.xyz_grad_accum),
        denom=_host(state.denom),
        adam_step=np.asarray(adam.step, np.int32),
        viewmatrix=_host(cam.viewmatrix),
        projmatrix=_host(cam.projmatrix),
        campos=_host(cam.campos),
        tanfovx=_host(cam.tanfovx),
        tanfovy=_host(cam.tanfovy),
        width=np.int32(cam.width),
        height=np.int32(cam.height),
        bg=_host(bg).astype(np.float32),
        iteration=np.int32(iteration),
        active_sh=np.int32(active_sh),
        gt_img=_host(gt_img),
    )
    np.savez_compressed(path, **payload)
    print(f"dumped faulting-step inputs to {path}")


def snapshot(iteration: int, state, adam, gen: torch.Generator, cfg) -> tuple:
    """(iteration, state, adam, generator state, raster config). The step,
    `densify_round` and the capacity growths return new tensors and never
    write their inputs, so the snapshot holds references, not copies."""
    return iteration, state, adam, gen.get_state(), cfg


def main(argv=None) -> dict:
    """Returns {"seconds", "losses" (the first pass's, one per
    iteration run), "alive" (after each step), "fault" (the iteration where
    a non-finite value was first seen, or None), "bad" (its report),
    "snapshot" (the iteration replayed from), "replay_losses" ({iteration:
    loss}), "dump" (the path written, or None)}."""
    ap = ArgumentParser(description="densification-run NaN hunt")
    ap.add_argument("outdir", nargs="?", default=os.path.join("build", "runs", "nan_hunt"))
    ap.add_argument("--iters", type=int, default=9000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    outdir, iters = args.outdir, args.iters
    scene_dir = os.path.join(outdir, "scene")
    model_dir = os.path.join(outdir, "model")
    os.makedirs(model_dir, exist_ok=True)
    if not os.path.exists(os.path.join(scene_dir, "split.yml")):
        from .densify_scale_run import build_dataset

        build_dataset(scene_dir, device=dev)

    from ..apps.train_3dgs import (
        CameraSampler, GtDeviceCache, densify_round, opt_params_from_args,
    )
    from ..config import ModelParams, OptimizationParams, PipelineParams
    from ..render import regrow_config, tuned_raster_config
    from ..scene import Scene
    from ..train import from_point_cloud, init_adam

    parser = ArgumentParser()
    ModelParams.add_to_parser(parser, "L")
    OptimizationParams.add_to_parser(parser, "O")
    PipelineParams.add_to_parser(parser, "P")
    a = parser.parse_args([
        "-s", scene_dir, "-m", model_dir, "--eval",
        "--split_yml_name", "split.yml", "--iterations", str(iters),
    ])
    dataset = ModelParams.extract(a).finalize()
    dataset.model_path = model_dir
    op = opt_params_from_args(OptimizationParams.extract(a))

    random.seed(0)
    np.random.seed(0)
    scene = Scene(dataset, load_gaussians=False, max_sh_degree=dataset.sh_degree)
    state = from_point_cloud(scene.init_points, scene.init_colors,
                             max_sh_degree=dataset.sh_degree, device=dev)
    adam = init_adam(state)
    cfg = tuned_raster_config(state.capacity)
    bg_fixed = np.array([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                        np.float32)

    sampler = CameraSampler(scene.get_train_cameras())
    gt_cache = GtDeviceCache(scene.get_train_cameras(), dev)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    active_sh = 0

    snaps = []       # ring of snapshot(...) tuples
    step_log = {}    # iteration -> (device camera, gt image, background)
    result = {"losses": [], "alive": [], "fault": None, "bad": {},
              "snapshot": None, "replay_losses": {}, "dump": None}

    def run_step(state, adam, cam, gt_img, bg, iteration, active_sh, cfg):
        zeros = torch.zeros((1,) + tuple(gt_img.shape[1:]), device=dev)
        return train_step(
            state, adam, cam, gt_img, zeros, zeros, iteration,
            torch.as_tensor(bg, device=dev),
            opt=op, sh_degree=active_sh, cfg=cfg,
            has_depth_cam=False, has_depth_est=False,
        )

    def densify(state, adam, iteration):
        return densify_round(state, adam, gen, iteration, op, scene.cameras_extent,
                             dataset.white_background)

    def replay(snap, upto):
        """Step by step from the snapshot with full checks."""
        it0, state, adam, gen_state, cfg = snap
        gen.set_state(gen_state)
        result["snapshot"] = it0
        print(f"\n=== replaying from iter {it0} to {upto} with per-step checks ===")
        for it in range(it0 + 1, upto + 1):
            cam, gt_img, bg = step_log[it]
            sh = min(it // 1000, dataset.sh_degree)
            prev_state, prev_adam = state, adam
            state, adam, metrics = run_step(state, adam, cam, gt_img, bg, it, sh, cfg)
            loss, _, dropped = read_step(metrics)
            result["replay_losses"][it] = loss
            bad = params_finite_report(state, adam)
            if not np.isfinite(loss) or bad:
                print(f"[REPLAY iter {it}] loss={loss} bad={bad}")
                print("pre-step param state:", params_finite_report(prev_state, prev_adam))
                result["dump"] = os.path.join(outdir, f"fault_iter{it}.npz")
                dump_step_inputs(result["dump"], prev_state, prev_adam, cam, bg, it, sh, gt_img)
                return True
            state, adam = densify(state, adam, it)
            bad = params_finite_report(state, adam)
            if bad:
                print(f"[REPLAY iter {it}] densify produced bad={bad}")
                result["dump"] = os.path.join(outdir, f"fault_densify_iter{it}.npz")
                dump_step_inputs(result["dump"], prev_state, prev_adam, cam, bg, it, sh, gt_img)
                return True
            cfg = regrow_config(cfg, dropped)
        print("replay clean?! (non-determinism or check cadence gap)")
        return False

    t0 = time.time()
    snaps.append(snapshot(0, state, adam, gen, cfg))
    for iteration in range(1, iters + 1):
        if iteration % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        cam, gt = sampler.next()
        bg = (rng.uniform(size=3).astype(np.float32)
              if op.random_background else bg_fixed)
        gt_img, _, _ = gt_cache.get(cam, gt)
        dcam = cam.to_torch(dev)
        step_log[iteration] = (dcam, gt_img, bg)
        step_log.pop(iteration - 2 * SNAP - 1, None)

        state, adam, metrics = run_step(state, adam, dcam, gt_img, bg, iteration, active_sh,
                                        cfg)
        loss, n_alive, dropped = read_step(metrics)
        result["losses"].append(loss)
        result["alive"].append(n_alive)
        fault = not np.isfinite(loss)
        bad = {}
        if not fault and iteration % SNAP == 0:
            bad = params_finite_report(state, adam)
            fault = bool(bad)
        if fault:
            print(f"\n[iter {iteration}] NON-FINITE detected: loss={loss} bad={bad} "
                  f"alive={n_alive}")
            result.update(fault=iteration, bad=bad)
            replay(snaps[0] if len(snaps) > 1 else snaps[-1], iteration)
            sampler.close()
            result["seconds"] = time.time() - t0
            return result

        state, adam = densify(state, adam, iteration)
        if dropped > 0:
            cfg = regrow_config(cfg, dropped)
            print(f"[iter {iteration}] raster keys -> {cfg.max_keys}")

        if iteration % SNAP == 0:
            snaps.append(snapshot(iteration, state, adam, gen, cfg))
            if len(snaps) > 2:
                snaps.pop(0)
        if iteration % 500 == 0:
            dt = time.time() - t0
            print(f"[iter {iteration}] loss={loss:.4f} alive={n_alive} "
                  f"({iteration / dt:.1f} it/s)")

    sampler.close()
    result["seconds"] = time.time() - t0
    print(f"\nNO NaN in {iters} iters ({result['seconds']:.0f}s) — "
          "not reproduced at this seed/scale")
    return result


if __name__ == "__main__":
    main()
