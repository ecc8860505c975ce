"""Eval rendering of refined / baseline 2DGS object models as RGBA, port of
`scorp_tpu.apps.render_2dgs` (the 2DGS twin of render_3dgs): renders the
test views of `refined_aligned/refined_{iter}.ply` into
`rendered_refined/` and of the `gs_seg/*.ply` objects (minus remained.ply)
into `rendered_baseline/`, with alpha = (render_alpha > 0), a white
background, and expected/median depth mixed by `--depth_ratio`.

    python -m scorp_tpu_torch.apps.render_2dgs -s <scene> -m <model> [--device cuda]
"""

from __future__ import annotations

import os
import shutil
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..config import ModelParams, PipelineParams, get_combined_args
from ..device import resolve_device
from ..render2d import render2d
from ..scene import Scene
from ..train import from_gaussian_data
from .render_3dgs import save_rgba


def _render_images(dataset, pretrained_ply_list, render_save_dir, device,
                   depth_ratio=1.0) -> list[dict]:
    """Render every test view; returns one record per view: its image name,
    wall seconds (render + copy to host), dropped keys and mean alpha."""
    shutil.rmtree(render_save_dir, ignore_errors=True)
    os.makedirs(render_save_dir)
    scene = Scene(dataset, shuffle=False, pretrained_ply_path_list=pretrained_ply_list,
                  max_sh_degree=dataset.sh_degree)
    state = from_gaussian_data(scene.gaussians, device=device)
    print(f"{scene.gaussians.n} Gaussians loaded")
    bg = torch.ones(3, device=device)

    records = []
    for cam in scene.get_test_cameras():
        t0 = time.perf_counter()
        out = render2d(cam.to_torch(device), state, bg, depth_ratio=depth_ratio)
        rgb = out["render"].cpu().numpy()
        alpha = out["render_alpha"].cpu().numpy()
        seconds = time.perf_counter() - t0
        save_rgba(os.path.join(render_save_dir, f"{cam.image_name}.png"), rgb,
                  (alpha > 0).astype(np.float32))
        records.append({
            "image": cam.image_name,
            "seconds": seconds,
            "num_dropped_keys": int(out["num_dropped_keys"]),
            "alpha_mean": float(alpha.mean()),
        })
    return records


def render_images(dataset, iteration=1000, render_proposed=True, render_baseline=True,
                  render_refined_dir_name="rendered_refined", depth_ratio=1.0,
                  device: str | torch.device = "cuda") -> dict[str, list[dict]]:
    """Returns {output dir: per-view records} (see _render_images)."""
    dev = resolve_device(device)
    results = {}
    if render_proposed:
        out_dir = os.path.join(dataset.model_path, render_refined_dir_name)
        results[out_dir] = _render_images(
            dataset,
            [os.path.join(dataset.model_path, "refined_aligned", f"refined_{iteration}.ply")],
            out_dir, dev, depth_ratio,
        )
    if render_baseline:
        seg_dir = os.path.join(dataset.model_path, "gs_seg")
        plys = [os.path.join(seg_dir, n) for n in os.listdir(seg_dir)
                if n.endswith(".ply") and n != "remained.ply"]
        out_dir = os.path.join(dataset.model_path, "rendered_baseline")
        results[out_dir] = _render_images(dataset, plys, out_dir, dev, depth_ratio)
    return results


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    parser.add_argument("--iter", type=int, default=1000)
    parser.add_argument("--not_render_proposed", action="store_true", default=False)
    parser.add_argument("--not_render_baseline", action="store_true", default=False)
    parser.add_argument("--render_refined_dir_name", type=str, default="rendered_refined")
    parser.add_argument("--depth_ratio", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (default cuda; cpu runs "
                             "the kernels' plain PyTorch versions)")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    args = get_combined_args(parser, argv)
    return render_images(
        ModelParams.extract(args).finalize(),
        iteration=args.iter,
        render_proposed=not args.not_render_proposed,
        render_baseline=not args.not_render_baseline,
        render_refined_dir_name=args.render_refined_dir_name,
        depth_ratio=args.depth_ratio,
        device=args.device,
    )


if __name__ == "__main__":
    main()
