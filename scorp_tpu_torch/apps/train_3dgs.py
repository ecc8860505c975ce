"""3DGS scene reconstruction trainer, port of `scorp_tpu.apps.train_3dgs`
(the same CLI, checkpoints and seeds).

    python -m scorp_tpu_torch.apps.train_3dgs -s <scene> -m <model> [--device cuda]

Each iteration is one `train_step` on the device (render + loss + backward
through kernels K1/K2/K3 + Adam + densification statistics). The host
feeds ground-truth images (prefetched by a background thread, cached on the
device) and runs densification every `densification_interval` iterations.
Gaussian capacity grows geometrically before a densification could run out
of slots, and the rasterizer's key capacities double after any iteration
that dropped keys.

`--device cpu` runs the kernels' plain PyTorch versions; without a GPU the
default `cuda` raises. `--gui` serves the SIBR network viewer on
`--ip`:`--port` once per iteration (`viewer.network_gui.gui_tick`; the
reference ships this hook commented out for 3DGS). `--profile <dir>` writes
a torch.profiler trace of the run (Chrome JSON) into <dir>, where the JAX
app writes a jax.profiler trace; it holds the program's spans
(`utils/trace.py`: the step's parts, the rasterizer's stages, densification
rounds).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue
import random
import sys
import threading
import time
import uuid
from argparse import ArgumentParser, Namespace
from dataclasses import fields

import numpy as np
import torch

from ..config import ModelParams, OptimizationParams, PipelineParams, save_cfg_args
from ..device import resolve_device
from ..render import regrow_config, render, tuned_raster_config
from ..render2d import render2d
from ..scene import Scene
from ..scene.cameras import Camera
from ..train import (
    Opt2DParams,
    OptParams,
    adam_from_numpy,
    count_densify_candidates,
    densify_and_prune,
    from_point_cloud,
    grow_capacity,
    init_adam,
    reset_opacity,
    round_capacity,
    state_from_numpy,
    to_gaussian_data,
    train_step,
    train_step_2d,
)
from ..utils.progress import ProgressMeter
from ..utils.trace import span
from ..viewer.network_gui import gui_tick, maybe_create_gui


def opt_params_from_args(opt: OptimizationParams, cls=OptParams) -> OptParams:
    """The step's hyperparameters (`cls`: OptParams, or Opt2DParams for
    surfels) from the CLI group: every field the two share; the rest keep
    their defaults (spatial_lr_scale its forced 1.0)."""
    return cls(**{f.name: getattr(opt, f.name) for f in fields(cls) if hasattr(opt, f.name)})


class GtDeviceCache:
    """Per-camera ground-truth tensors on the device, when they fit a budget
    (the reference keeps GT on the GPU per camera too); zero depth maps are
    shared per resolution either way."""

    def __init__(self, cameras, device, budget_bytes: int = 4 << 30):
        est = sum(
            c.resolution[0] * c.resolution[1] * 3 * 4
            * (2 if c.depth_cam_path is not None else 1)
            for c in cameras
        )
        self.enabled = est <= budget_bytes
        self.device = device
        self.imgs: dict = {}
        self.zeros: dict = {}

    def _zero(self, h, w):
        z = self.zeros.get((h, w))
        if z is None:
            z = torch.zeros((1, h, w), device=self.device)
            self.zeros[(h, w)] = z
        return z

    def get(self, cam, gt):
        key = id(cam)
        if self.enabled and key in self.imgs:
            return self.imgs[key]
        h, w = gt.image.shape[1], gt.image.shape[2]
        zero_d = self._zero(h, w)

        def upload(a):
            return torch.as_tensor(a, device=self.device) if a is not None else zero_d

        val = (upload(gt.image), upload(gt.depth_cam), upload(gt.depth_est))
        if self.enabled:
            self.imgs[key] = val
        return val


class CameraSampler:
    """Random-camera-without-replacement stack + background GT prefetch."""

    def __init__(self, cameras: list[Camera], prefetch: int = 4):
        self.cameras = cameras
        self.stack: list[Camera] = []
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.stop = False
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _next_cam(self) -> Camera:
        if not self.stack:
            self.stack = self.cameras.copy()
        return self.stack.pop(random.randint(0, len(self.stack) - 1))

    def _worker(self):
        while not self.stop:
            cam = self._next_cam()
            item = (cam, cam.gt(release=True))
            # retry with the same item until consumed or stopped
            while not self.stop:
                try:
                    self.q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    pass

    def next(self):
        return self.q.get()

    def close(self):
        self.stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join()


def save_checkpoint(path: str, state, adam, iteration: int):
    """A pickle with the JAX package's payload keys, so checkpoints move
    between the two packages in both directions."""
    payload = {
        "params": {k: v.cpu().numpy() for k, v in state.params.items()},
        "alive": state.alive.cpu().numpy(),
        "max_radii2d": state.max_radii2d.cpu().numpy(),
        "xyz_grad_accum": state.xyz_grad_accum.cpu().numpy(),
        "denom": state.denom.cpu().numpy(),
        "adam_m": {k: v.cpu().numpy() for k, v in adam.m.items()},
        "adam_v": {k: v.cpu().numpy() for k, v in adam.v.items()},
        "adam_step": int(adam.step),
        "iteration": iteration,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path: str, device) -> tuple:
    with open(path, "rb") as f:
        p = pickle.load(f)
    state = state_from_numpy(p["params"], p["alive"], device, p["max_radii2d"],
                             p["xyz_grad_accum"], p["denom"])
    adam = adam_from_numpy(p["adam_m"], p["adam_v"], p["adam_step"], device)
    return state, adam, p["iteration"]


def evaluate(scene: Scene, state, sh_degree: int, bg, cfg, iteration: int, device,
             quiet=False, render_fn=render, dropped_keys: list | None = None):
    """In-loop test/train eval (the reference's training_report), rendered
    by `render_fn` (`render`, or `render2d` for surfels) from the live padded
    state with the training RasterConfig. Each view's dropped-key count is
    appended to `dropped_keys` when a list is given, whatever `quiet`."""
    results = {}
    train_cams = scene.get_train_cameras()
    configs = [
        ("test", scene.get_test_cameras()),
        ("train", [train_cams[i % len(train_cams)] for i in range(5, 30, 5)] if train_cams else []),
    ]
    with torch.no_grad():
        for name, cams in configs:
            if not cams:
                continue
            l1s, psnrs = [], []
            for cam in cams:
                out = render_fn(cam.to_torch(device), state, bg, sh_degree=sh_degree, cfg=cfg)
                n_dropped = int(out["num_dropped_keys"])
                if dropped_keys is not None:
                    dropped_keys.append(n_dropped)
                if n_dropped > 0 and not quiet:
                    print(f"\n[ITER {iteration}] eval view dropped {n_dropped} keys")
                img = np.clip(out["render"].cpu().numpy(), 0.0, 1.0)
                gt = np.clip(cam.gt(release=True).image, 0.0, 1.0)
                l1s.append(float(np.abs(img - gt).mean()))
                mse = float(((img - gt) ** 2).mean())
                psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            results[name] = (float(np.mean(l1s)), float(np.mean(psnrs)))
            if not quiet:
                print(f"\n[ITER {iteration}] Evaluating {name}: "
                      f"L1 {results[name][0]} PSNR {results[name][1]}")
    return results


def densify_round(state, adam, gen, iteration: int, opt, cameras_extent: float,
                  white_background: bool, log: dict | None = None):
    """The densification of one iteration of the trainer's loop -> (state,
    adam): every `densification_interval` iterations after
    `densify_from_iter` (until `densify_until_iter`) a capacity growth if
    the candidates could run out of free slots, `densify_and_prune` with
    split samples from the torch.Generator `gen`, and a growth when the
    state fills; the opacity reset every `opacity_reset_interval`. `opt`
    is the CLI group or the step's OptParams (the fields are the same).
    With `log`, each capacity change and round is appended to its
    "capacity" and "densify" lists (see `training`)."""
    if iteration >= opt.densify_until_iter:
        return state, adam
    if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
        with span("densify.round"):
            use_size = iteration > opt.opacity_reset_interval
            # pre-grow so the densify scatter never runs out of slots
            expected_new = int(count_densify_candidates(state, opt.densify_grad_threshold))
            n_alive = int(state.num_alive())
            if n_alive + expected_new > 0.95 * state.capacity:
                new_cap = round_capacity(
                    max(int(state.capacity * 2.0), int((n_alive + expected_new) * 1.2)))
                print(f"\n[ITER {iteration}] capacity {state.capacity} -> {new_cap}")
                if log is not None:
                    log["capacity"].append((iteration, state.capacity, new_cap))
                state, adam = grow_capacity(state, adam, new_cap)
            state, adam, dropped = densify_and_prune(
                state, adam, gen,
                opt.densify_grad_threshold, opt.opacity_cull,
                cameras_extent, opt.percent_dense,
                max_screen_size=opt.max_screen_size,
                use_size_threshold=use_size,
            )
            n_before, n_alive = n_alive, int(state.num_alive())
            if log is not None:
                log["densify"].append((iteration, n_before, expected_new, n_alive, int(dropped)))
            # grow BEFORE the buffer can saturate (a saturated densify
            # drops clone/split candidates the reference would keep)
            if int(dropped) > 0 or n_alive > 0.7 * state.capacity:
                new_cap = round_capacity(int(state.capacity * 2.0))
                print(f"\n[ITER {iteration}] capacity {state.capacity} -> {new_cap} "
                      f"(alive {n_alive}, dropped {int(dropped)})")
                if log is not None:
                    log["capacity"].append((iteration, state.capacity, new_cap))
                state, adam = grow_capacity(state, adam, new_cap)
    if iteration % opt.opacity_reset_interval == 0 or (
        white_background and iteration == opt.densify_from_iter
    ):
        state, adam = reset_opacity(state, adam)
    return state, adam


def training(
    dataset: ModelParams,
    opt: OptimizationParams,
    pipe: PipelineParams,
    testing_iterations,
    saving_iterations,
    checkpoint_iterations,
    checkpoint,
    debug_from,
    quiet: bool = False,
    device: str | torch.device = "cuda",
    surfel: bool = False,
    ip: str | None = None,
    port: int = 6009,
):
    """Returns (scene, state, adam, log) with `log` holding each
    iteration's loss and dropped-key count, the capacity changes, the raster
    regrows, the (iteration, degree) of each SH-degree step, the (iteration,
    results) of each in-loop evaluation with the (iteration, keys dropped
    over its views) beside it, and the (iteration, alive before, candidates,
    alive after, dropped candidates) of each densification.

    `surfel=True` is the 2DGS trainer's loop (apps/train_2dgs.py): surfels
    from the point cloud, `train_step_2d` with Opt2DParams and `render2d`
    for the evaluations; everything else is shared. With `ip`, the SIBR
    viewer is served on ip:port once per iteration."""
    dev = resolve_device(device)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    os.makedirs(dataset.model_path, exist_ok=True)
    print(f"Output folder: {dataset.model_path}")

    tb_writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(dataset.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")

    scene = Scene(dataset, load_gaussians=False, max_sh_degree=dataset.sh_degree)
    op = opt_params_from_args(opt, Opt2DParams if surfel else OptParams)
    step_fn, render_fn = (train_step_2d, render2d) if surfel else (train_step, render)

    state = from_point_cloud(scene.init_points, scene.init_colors,
                             max_sh_degree=dataset.sh_degree, surfel=surfel, device=dev)
    adam = init_adam(state)
    first_iter = 0
    if checkpoint:
        state, adam, first_iter = load_checkpoint(checkpoint, dev)
        print(f"Restored checkpoint at iteration {first_iter}")

    bg_fixed = np.array([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                        np.float32)
    cfg = tuned_raster_config(state.capacity)

    gui = maybe_create_gui(ip, port)

    def gui_render(minicam, scaling_modifier):
        with torch.no_grad():
            out = render_fn(minicam.to_torch(dev), state, bg_fixed,
                            scaling_modifier=float(scaling_modifier), sh_degree=active_sh,
                            cfg=cfg)
        return out["render"].cpu().numpy()

    sampler = CameraSampler(scene.get_train_cameras())
    gt_cache = GtDeviceCache(scene.get_train_cameras(), dev)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # a restored run resumes at the SH degree the schedule had reached
    active_sh = min(first_iter // 1000, dataset.sh_degree)
    meter = ProgressMeter(opt.iterations, disable=quiet)
    log = {"loss": [], "dropped_keys": [], "capacity": [], "raster_keys": [], "eval": [],
           "eval_dropped_keys": [], "densify": [], "sh_degree": []}

    t_start = time.time()
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if iteration % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
            log["sh_degree"].append((iteration, active_sh))

        if gui is not None:
            gui_tick(gui, gui_render, dataset.source_path, iteration, opt.iterations)

        cam, gt = sampler.next()
        bg = rng.uniform(size=3).astype(np.float32) if opt.random_background else bg_fixed
        gt_img, gt_dcam, gt_dest = gt_cache.get(cam, gt)
        state, adam, metrics = step_fn(
            state, adam, cam.to_torch(dev),
            gt_img, gt_dcam, gt_dest,
            iteration, torch.as_tensor(bg, device=dev),
            opt=op, sh_degree=active_sh, cfg=cfg,
            has_depth_cam=gt.depth_cam is not None,
            has_depth_est=gt.depth_est is not None,
        )
        log["loss"].append(metrics.loss)

        meter.update(iteration, metrics)
        if tb_writer is not None and iteration % 10 == 0:
            tb_writer.add_scalar("train_loss_patches/l1_loss", float(metrics.l1), iteration)
            tb_writer.add_scalar("train_loss_patches/total_loss", float(metrics.loss), iteration)
            tb_writer.add_scalar("total_points", int(metrics.num_alive), iteration)

        if iteration in testing_iterations:
            eval_dropped: list[int] = []
            results = evaluate(scene, state, active_sh, bg_fixed, cfg, iteration, dev,
                               quiet=quiet, render_fn=render_fn, dropped_keys=eval_dropped)
            log["eval"].append((iteration, results))
            log["eval_dropped_keys"].append((iteration, sum(eval_dropped)))
            if tb_writer is not None:
                for name, (l1v, psnrv) in results.items():
                    tb_writer.add_scalar(f"{name}/loss_viewpoint - l1_loss", l1v, iteration)
                    tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr", psnrv, iteration)
        if iteration in saving_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, to_gaussian_data(state))

        state, adam = densify_round(state, adam, gen, iteration, opt, scene.cameras_extent,
                                    dataset.white_background, log)

        # rasterizer capacity growth on overflow
        dropped_keys = int(metrics.num_dropped_keys)
        log["dropped_keys"].append(dropped_keys)
        if dropped_keys > 0:
            cfg = regrow_config(cfg, dropped_keys)
            log["raster_keys"].append((iteration, cfg.max_keys, cfg.stream_keys))
            print(f"\n[ITER {iteration}] raster capacity -> keys={cfg.max_keys} "
                  f"stream={cfg.stream_keys}")

        if iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            save_checkpoint(os.path.join(scene.model_path, f"chkpnt{iteration}.pth"),
                            state, adam, iteration)

    sampler.close()
    meter.close()
    if gui is not None:
        gui.close()
    if tb_writer is not None:
        tb_writer.close()
    wall = time.time() - t_start
    iters = opt.iterations - first_iter
    log["loss"] = [float(x) for x in log["loss"]]
    print(f"\nTraining done: {iters} iters in {wall:.1f}s "
          f"({iters / max(wall, 1e-9):.2f} it/s), {int(state.num_alive())} gaussians")
    return scene, state, adam, log


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    OptimizationParams.add_to_parser(parser, "Optimization Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--gui", action="store_true", default=False)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 10_000, 15_000, 20_000, 25_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[5_000, 7_000, 10_000, 15_000, 20_000, 25_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler trace (Chrome JSON) to this directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    args.save_iterations.append(args.iterations)

    random.seed(0)
    np.random.seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    print("Optimizing " + args.model_path)
    dataset = ModelParams.extract(args).finalize()
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    args.model_path = dataset.model_path
    save_cfg_args(dataset.model_path, Namespace(**vars(args)))

    with profiled(args.profile, device):
        result = training(
            dataset,
            OptimizationParams.extract(args),
            PipelineParams.extract(args),
            args.test_iterations,
            args.save_iterations,
            args.checkpoint_iterations,
            args.start_checkpoint,
            args.debug_from,
            quiet=args.quiet,
            device=device,
            ip=args.ip if args.gui else None,
            port=args.port,
        )
    print("\nTraining complete.")
    return result


@contextlib.contextmanager
def profiled(trace_dir: str | None, device: torch.device):
    """torch.profiler over the block (host ops, the program's spans, and
    CUDA kernels on a CUDA device), written to
    <trace_dir>/train_3dgs.pt.trace.json; nothing without a directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "train_3dgs.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


if __name__ == "__main__":
    main()
