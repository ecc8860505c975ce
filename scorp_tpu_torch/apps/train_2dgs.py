"""2DGS (surfel) scene reconstruction trainer, port of
`scorp_tpu.apps.train_2dgs` (the same CLI, checkpoints and seeds).

    python -m scorp_tpu_torch.apps.train_2dgs -s <scene> -m <model> [--device cuda]

It shares the 3DGS trainer's loop (`apps/train_3dgs.training`: camera
sampling and GT prefetch, densification and capacity growth, raster
capacity regrowth, evaluation, checkpoints) with the surfel pieces swapped
in: surfels from the point cloud (2 scale columns, random rotations), one
`train_step_2d` per iteration (render + losses with the normal and
distortion regularizers + backward through kernels K1/K5/K6 + Adam +
densification statistics), `render2d` for the evaluations, and the 2DGS
hyperparameter deltas (`Optimization2DParams`: lambda_dist, depth_ratio,
opacity_cull 0.5, max_screen_size 0.2, ...).

`--device cpu` runs the kernels' plain PyTorch versions; without a GPU the
default `cuda` raises. `--gui` serves the SIBR network viewer on
`--ip`:`--port` once per iteration, frames rendered by `render2d` (the
reference's live viewer call site).
"""

from __future__ import annotations

import os
import random
import sys
import uuid
from argparse import ArgumentParser, Namespace

import numpy as np
import torch

from ..config import ModelParams, Optimization2DParams, PipelineParams, save_cfg_args
from ..device import resolve_device
from .train_3dgs import training


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    Optimization2DParams.add_to_parser(parser, "Optimization Parameters")
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
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    args.save_iterations.append(args.iterations)

    random.seed(0)
    np.random.seed(0)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    dataset = ModelParams.extract(args).finalize()
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    args.model_path = dataset.model_path
    save_cfg_args(dataset.model_path, Namespace(**vars(args)))
    print("Optimizing " + dataset.model_path)

    result = training(
        dataset, Optimization2DParams.extract(args), PipelineParams.extract(args),
        args.test_iterations, args.save_iterations,
        args.checkpoint_iterations, args.start_checkpoint, args.debug_from,
        quiet=args.quiet, device=device, surfel=True,
        ip=args.ip if args.gui else None, port=args.port,
    )
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
