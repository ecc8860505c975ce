"""Registration-constrained refinement of aligned proxies, port of
`scorp_tpu.apps.post_refine_gs` (the reference's `post_refine_gs.py` CLI):
load every generated_aligned/*.ply named after generated/*.ply, merge,
freeze geometry (colour only), optimize `--iterations` steps of masked
L1+SSIM (`train/refine.py:refine_step`) against the union-mask RGBA ground
truth (--images should point at masked_image_rgba/masked), then split the
merged model back into refined_aligned/<obj>.ply + refined_{iter}.ply.

Cameras are drawn without replacement by a `random.Random(seed)`, which also
shuffles the scene's camera lists: the JAX app draws from the global
`random` after its `random.seed(0)`, so the two take the same order.

    python -m scorp_tpu_torch.apps.post_refine_gs -s <scene> -m <model> --sh_degree 0 \
        --images masked_image_rgba/masked [--device cuda]
"""

from __future__ import annotations

import os
import random
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..config import ModelParams, OptimizationParams, PipelineParams
from ..core.plyio import save_gaussian_ply
from ..device import resolve_device
from ..render import default_raster_config
from ..scene import Scene
from ..train import from_gaussian_data, init_adam, refine_step, to_gaussian_data
from ..utils.progress import ProgressMeter
from .train_3dgs import opt_params_from_args


def training(dataset: ModelParams, opt: OptimizationParams, pipe: PipelineParams,
             quiet: bool = False, device: str | torch.device = "cuda", seed: int = 0):
    """Returns (the refined GaussianData, {"loss": per-iteration losses})."""
    dev = resolve_device(device)
    pretrained_dir = os.path.join(dataset.model_path, "generated_aligned")
    if not os.path.exists(pretrained_dir):
        raise FileNotFoundError(f"Pretrained PLY directory not found at {pretrained_dir}")
    names = [n for n in os.listdir(os.path.join(dataset.model_path, "generated"))
             if n.endswith(".ply")]
    paths = [os.path.join(pretrained_dir, n) for n in names]
    if not paths:
        raise FileNotFoundError(f"No PLY files found in the directory {pretrained_dir}")

    if dataset.sh_degree != 0:
        raise ValueError("SH degree must be 0 for post-refine")
    rng_cams = random.Random(seed)
    scene = Scene(dataset, pretrained_ply_path_list=paths, max_sh_degree=dataset.sh_degree,
                  rng=rng_cams)
    sizes = scene.gaussian_sizes

    state = from_gaussian_data(scene.gaussians, device=dev)
    adam = init_adam(state)
    op = opt_params_from_args(opt)
    cfg = default_raster_config(state.capacity)

    bg_fixed = np.array([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                        np.float32)
    rng = np.random.default_rng(0)
    cams = scene.get_train_cameras()
    gt_cache: dict = {}
    stack: list = []
    losses = []
    meter = ProgressMeter(opt.iterations, disable=quiet)

    refined_dir = os.path.join(dataset.model_path, "refined_aligned")
    os.makedirs(refined_dir, exist_ok=True)

    for iteration in range(1, opt.iterations + 1):
        if not stack:
            stack = cams.copy()
        cam = stack.pop(rng_cams.randint(0, len(stack) - 1))
        if cam.image_name not in gt_cache:
            gt = cam.gt()
            if gt.alpha is None:
                raise RuntimeError(
                    f"{cam.image_name}: ground truth has no alpha — point --images at "
                    "masked_image_rgba/masked"
                )
            gt_cache[cam.image_name] = (torch.as_tensor(gt.image, device=dev),
                                        torch.as_tensor(gt.alpha, device=dev))
        gt_image, gt_alpha = gt_cache[cam.image_name]
        bg = rng.uniform(size=3).astype(np.float32) if opt.random_background else bg_fixed
        state, adam, metrics = refine_step(
            state, adam, cam.to_torch(dev), gt_image, gt_alpha, iteration,
            torch.as_tensor(bg, device=dev), opt=op, sh_degree=0, cfg=cfg,
        )
        losses.append(metrics["loss"])
        if iteration % 10 == 0:
            meter.ema_loss = 0.4 * float(metrics["loss"]) + 0.6 * meter.ema_loss
            if meter.bar is not None:
                meter.bar.set_postfix({"Loss": f"{meter.ema_loss:.5f}"})
                meter.bar.update(10)

    # split the merged model back per object by its size bookkeeping
    shutil.rmtree(refined_dir, ignore_errors=True)
    os.makedirs(refined_dir)
    print(f"\n[ITER {opt.iterations}] Saving Gaussians")
    g = to_gaussian_data(state)
    offset = 0
    for size, name in zip(sizes, names):
        save_gaussian_ply(os.path.join(refined_dir, name),
                          g.select(np.arange(offset, offset + size)))
        offset += size
    save_gaussian_ply(os.path.join(refined_dir, f"refined_{opt.iterations}.ply"), g)
    return g, {"loss": torch.stack(losses).tolist() if losses else []}


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    OptimizationParams.add_to_parser(parser, "Optimization Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to refine on (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)

    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    print("Optimizing " + args.model_path)
    result = training(
        ModelParams.extract(args).finalize(),
        OptimizationParams.extract(args),
        PipelineParams.extract(args),
        quiet=args.quiet,
        device=device,
    )
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
