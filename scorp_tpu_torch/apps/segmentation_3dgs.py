"""3D segmentation: lift 2D object masks to per-Gaussian masks by gradient
voting and write per-object PLYs, port of `scorp_tpu.apps.segmentation_3dgs`
(the reference's `segmentation_3dgs.py` CLI): loads the iteration-7000
reconstruction, reads the prompts from description.yml, votes on the
device, and writes model_path/gs_seg/<prompt>.ply + remained.ply.

    python -m scorp_tpu_torch.apps.segmentation_3dgs -s <scene> -m <model> [--device cuda]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch
import yaml

from ..config import ModelParams, PipelineParams
from ..core.plyio import GaussianData, save_gaussian_ply
from ..device import resolve_device
from ..pipeline.mask3d import get_mask3d
from ..scene import Scene
from ..train import from_gaussian_data


def apply_mask3d(g: GaussianData, mask3d: np.ndarray, path: str) -> GaussianData:
    sel = g.select(mask3d)
    save_gaussian_ply(path, sel)
    return sel


def mask3d(dataset: ModelParams, pipeline: PipelineParams, iteration: int = 7000,
           device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    description_path = os.path.join(dataset.source_path, "description.yml")
    if not os.path.exists(description_path):
        raise FileNotFoundError(f"Config file not found at {description_path}")
    with open(description_path) as f:
        description = yaml.safe_load(f)
    prompts = [p.strip() for p in description["prompts"].split(",")]

    scene = Scene(dataset, load_iteration=iteration, shuffle=False,
                  max_sh_degree=dataset.sh_degree)
    g = scene.gaussians
    state = from_gaussian_data(g, device=dev)
    bg = np.array([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                  np.float32)

    masks_3d = get_mask3d(
        state,
        scene.get_train_cameras(),
        prompts,
        dataset.source_path,
        bg=bg,
    )
    masks_3d = masks_3d[:, : g.n]  # drop capacity padding

    gs_seg_path = os.path.join(dataset.model_path, "gs_seg")
    os.makedirs(gs_seg_path, exist_ok=True)
    for mask, prompt in zip(masks_3d, prompts):
        apply_mask3d(g, mask, os.path.join(gs_seg_path, f"{prompt}.ply"))
    remained_mask = ~(masks_3d.sum(axis=0) > 0)
    apply_mask3d(g, remained_mask, os.path.join(gs_seg_path, "remained.ply"))
    return masks_3d


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to vote on (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    return mask3d(ModelParams.extract(args).finalize(), PipelineParams.extract(args),
                  device=args.device)


if __name__ == "__main__":
    main()
