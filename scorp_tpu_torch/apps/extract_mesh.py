"""Mesh extraction CLI for trained 2DGS models, port of
`scorp_tpu.apps.extract_mesh`: renders the training views through the
port's `render2d` (K1, then the surfel compositor K4), TSDF-fuses their
depth and colour into a `TsdfVolume` on the device (kernel T on the card),
triangulates the grid by marching cubes on its own device (kernel M on the
card, the vertices mapped to world coordinates there; only the mesh reaches
the host, so `--unbounded --mesh_res 1024` fits), writes
`train/ours_<iter>/fuse.ply`, then the floater-filtered `fuse_post.ply`
(`post_process_mesh`, on the host).

Auto knobs as the 2DGS upstream's: depth_trunc = 2 x scene radius,
voxel_size = depth_trunc / mesh_res, sdf_trunc = 5 x voxel_size.

    python -m scorp_tpu_torch.apps.extract_mesh -s <scene> -m <model> [--device cuda]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..config import ModelParams, PipelineParams, get_combined_args
from ..device import resolve_device
from ..pipeline.mesh import GaussianExtractor, post_process_mesh, save_mesh_ply
from ..render2d import render2d
from ..scene import Scene
from ..train import from_gaussian_data


def extract(dataset, iteration=-1, voxel_size=-1.0, sdf_trunc=-1.0,
            depth_trunc=-1.0, mesh_res=256, num_cluster=50,
            unbounded=False, depth_ratio=1.0, out_dir=None,
            device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    scene = Scene(dataset, load_iteration=iteration, shuffle=False,
                  max_sh_degree=dataset.sh_degree)
    state = from_gaussian_data(scene.gaussians, device=dev)
    bg = torch.zeros(3, device=dev)

    def render_fn(cam):
        return render2d(cam.to_torch(dev), state, bg, depth_ratio=depth_ratio)

    cams = scene.get_train_cameras()
    radius = float(scene.cameras_extent)
    if depth_trunc < 0:
        depth_trunc = radius * 2.0
    if voxel_size < 0:
        voxel_size = depth_trunc / mesh_res
    if sdf_trunc < 0:
        sdf_trunc = voxel_size * 5.0

    ex = GaussianExtractor(render_fn, cams, device=dev)
    if unbounded:
        verts, faces, cols = ex.extract_mesh_unbounded(
            np.zeros(3), radius, resolution=mesh_res, depth_trunc=depth_trunc)
    else:
        verts, faces, cols = ex.extract_mesh_bounded(
            np.zeros(3), radius, voxel_size=voxel_size, sdf_trunc=sdf_trunc,
            depth_trunc=depth_trunc, max_resolution=mesh_res)

    out_dir = out_dir or os.path.join(
        dataset.model_path, "train", f"ours_{scene.loaded_iter}")
    os.makedirs(out_dir, exist_ok=True)
    save_mesh_ply(os.path.join(out_dir, "fuse.ply"), verts, faces, cols)
    print(f"mesh saved at {os.path.join(out_dir, 'fuse.ply')} "
          f"({len(verts)} verts, {len(faces)} faces)")

    pverts, pfaces, pcols = post_process_mesh(verts, faces, cols,
                                              cluster_to_keep=num_cluster)
    save_mesh_ply(os.path.join(out_dir, "fuse_post.ply"), pverts, pfaces, pcols)
    print(f"mesh post processed and saved at "
          f"{os.path.join(out_dir, 'fuse_post.ply')} "
          f"({len(pverts)} verts, {len(pfaces)} faces)")
    return out_dir


def main(argv=None):
    parser = ArgumentParser(description="Mesh extraction parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--voxel_size", default=-1.0, type=float,
                        help="Mesh: voxel size for TSDF")
    parser.add_argument("--depth_trunc", default=-1.0, type=float,
                        help="Mesh: Max depth range for TSDF")
    parser.add_argument("--sdf_trunc", default=-1.0, type=float,
                        help="Mesh: truncation value for TSDF")
    parser.add_argument("--num_cluster", default=50, type=int,
                        help="Mesh: number of connected clusters to export")
    parser.add_argument("--unbounded", action="store_true",
                        help="Mesh: using unbounded mode for meshing")
    parser.add_argument("--mesh_res", default=256, type=int,
                        help="Mesh: resolution for unbounded mesh extraction (the 2DGS "
                             "reference code uses 1024 for unbounded scenes such as "
                             "Mip-NeRF 360's; 256 is the JAX package's default)")
    parser.add_argument("--depth_ratio", default=1.0, type=float)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and fuse on (default cuda; cpu runs "
                             "the kernels' plain PyTorch versions)")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    args = get_combined_args(parser, argv)
    device = resolve_device(args.device)
    return extract(
        ModelParams.extract(args).finalize(),
        iteration=args.iteration,
        voxel_size=args.voxel_size,
        sdf_trunc=args.sdf_trunc,
        depth_trunc=args.depth_trunc,
        mesh_res=args.mesh_res,
        num_cluster=args.num_cluster,
        unbounded=args.unbounded,
        depth_ratio=args.depth_ratio,
        device=device,
    )


if __name__ == "__main__":
    main()
