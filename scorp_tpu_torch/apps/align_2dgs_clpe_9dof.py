"""9-DoF proxy alignment for 2DGS reconstructions, port of
`scorp_tpu.apps.align_2dgs_clpe_9dof` (the reference's
`align_2dgs_clpe_9dof.py` CLI): the 3DGS alignment, except that the
segmented SCENE object's depth renders go through the port's surfel
renderer `render2d` (K1, then K4); the generated proxy keeps the 3DGS
`render` (K1, then K2). Like the 3DGS twin, `align` takes `matcher_kwargs`.

    python -m scorp_tpu_torch.apps.align_2dgs_clpe_9dof -s <scene> -m <model> [--device cuda]
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import torch
import yaml

from ..config import ModelParams, PipelineParams
from ..device import resolve_device
from ..render2d import render2d
from ..train import from_gaussian_data
from .align_3dgs_clpe_9dof import align as align_base


def _scene_render_2d(cam, gaussians, bg, device):
    out = render2d(cam.to_torch(device), from_gaussian_data(gaussians, device=device), bg)
    return {k: out[k].cpu().numpy() for k in ("render", "render_depth", "render_alpha")}


def align(dataset, pipeline, object_name, num_iterations=6, opt_12dof_iterations=(3,),
          cam_list_interval=10, rotations_path="rotation_matrices",
          visual_match=False, matcher_backend="auto", matcher_kwargs: dict | None = None,
          device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    return align_base(
        dataset, pipeline, object_name, num_iterations, opt_12dof_iterations,
        cam_list_interval, rotations_path, visual_match, matcher_backend,
        scene_render=lambda cam, g, bg: _scene_render_2d(cam, g, bg, dev),
        matcher_kwargs=matcher_kwargs, device=dev,
    )


def align_objects(dataset, pipeline, num_iterations=6, opt_12dof_iterations=(3,),
                  cam_list_interval=10, rotations_path="rotation_matrices",
                  visual_match=False, matcher_backend="auto", device="cuda"):
    selected = os.path.join(dataset.model_path, "masked_image_rgba_selected")
    if not os.path.exists(selected):
        raise FileNotFoundError(f"RGBA path not found at {selected}")
    for object_name in os.listdir(selected):
        align(dataset, pipeline, object_name, num_iterations, opt_12dof_iterations,
              cam_list_interval, rotations_path, visual_match, matcher_backend,
              device=device)


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--name", type=str, default="None")
    parser.add_argument("--rotations_dir", default="rotation_matrices", type=str)
    parser.add_argument("--matcher", default="auto", type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and solve on (default cuda; cpu "
                             "runs the kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    dataset = ModelParams.extract(args).finalize()

    description_path = os.path.join(dataset.source_path, "description.yml")
    with open(description_path) as f:
        description = yaml.safe_load(f)
    num_iterations = description.get("num_iterations", 6)
    opt_12dof = description.get("opt_shape_iterations", [3, 4])
    cam_interval = description.get("cam_list_interval", 10)

    pipeline = PipelineParams.extract(args)
    if args.name != "None":
        align(dataset, pipeline, args.name, num_iterations, opt_12dof, cam_interval,
              args.rotations_dir, visual_match=True, matcher_backend=args.matcher,
              device=device)
    else:
        align_objects(dataset, pipeline, num_iterations, opt_12dof, cam_interval,
                      args.rotations_dir, visual_match=True, matcher_backend=args.matcher,
                      device=device)


if __name__ == "__main__":
    main()
