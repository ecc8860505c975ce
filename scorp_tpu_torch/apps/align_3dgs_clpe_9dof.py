"""9-DoF proxy alignment, the SCORP core loop, port of
`scorp_tpu.apps.align_3dgs_clpe_9dof` (the reference's
`align_3dgs_clpe_9dof.py` CLI).

Per object: load the segmented scene object (SH3) and the generated proxy
(SH0); coarse init = bbox-ratio scale + centroid translation + best-of-67
multi-init ICP (batched on the device, pipeline/icp.py); then
`num_iterations` rounds of render-and-match (render the proxy through the
port's `render`, K1 and K2, at up to 3.375x the camera's resolution until it
covers enough pixels; match crops against the masked input via the
pluggable matcher, by default SIFT on the same device; lift both match
sets to 3D through rendered depths)
solved with RANSAC-Umeyama (7-DoF) or, on `opt_shape_iterations`, the Adam
9-DoF optimizer with orthogonal-frame anisotropic scale. Writes
model_path/generated_aligned/<obj>_{iter}.ply and the final <obj>.ply.

    python -m scorp_tpu_torch.apps.align_3dgs_clpe_9dof -s <scene> -m <model> [--device cuda]

`align` takes `matcher_kwargs` for `get_matcher`, e.g. the directory of the
"precomputed" backend (the JAX app passes none, so its precomputed backend
cannot be made).
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import torch
import yaml
from PIL import Image

from ..assets import load_rotation_bank
from ..config import ModelParams, PipelineParams
from ..core.camera import fov2focal
from ..core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
from ..device import resolve_device
from ..pipeline.graphic import get_centroid, pix2pcd
from ..pipeline.gs_transform import gaussians_rotate, gaussians_scale, gaussians_translate
from ..pipeline.icp import best_icp_transform
from ..pipeline.image_utils import crop_with_alpha, restore_coords, show_feature_matches
from ..pipeline.matching import get_matcher
from ..pipeline.solvers import adam_algorithm_3d3d_9dof, pc_align_ransac
from ..render import render
from ..scene import Scene
from ..train import from_gaussian_data


def _to_pil(chw: np.ndarray) -> Image.Image:
    arr = (np.clip(np.nan_to_num(chw), 0.0, 1.0) * 255.0).astype(np.uint8)
    return Image.fromarray(arr.transpose(1, 2, 0).squeeze())


def _render_np(cam, gaussians: GaussianData, bg, device):
    """Render a host camera's view of host Gaussians on `device` -> numpy."""
    out = render(cam.to_torch(device), from_gaussian_data(gaussians, device=device), bg)
    return {k: out[k].cpu().numpy() for k in ("render", "render_depth", "render_alpha")}


def apply_scale(g: GaussianData, scale):
    scale = np.asarray(scale, dtype=float)
    if np.isnan(scale).any():
        raise ValueError("Scale cannot be Nan")
    if scale.size == 1:
        scale = np.repeat(scale.reshape(1), 3)
    elif scale.size != 3:
        raise ValueError("Scale must be a scalar or a 3-element array")
    gaussians_scale(g, scale.astype(np.float32))
    print(f"scaled by {scale}")


def apply_transformation(g: GaussianData, R, t):
    gaussians_rotate(g, np.asarray(R, np.float64))
    gaussians_translate(g, np.asarray(t, np.float32))


def get_pcd_pair(
    gaussian_refined: GaussianData,
    cam_list,
    bg,
    matcher,
    mask_images_crop,
    mask_depthes_crop,
    mask_areas,
    mask_bbox_xxyys,
    iteration: int = -1,
    n_points_per_cam: int = 12,
    cam_list_interval: int = 10,
    visual_match_save_path: str | None = None,
    device: str | torch.device = "cuda",
):
    """Render the proxy per sampled camera on `device`, match 2D features
    against the masked object crops, lift both sides to world-space 3D
    point pairs."""
    dev = resolve_device(device)
    start = iteration % cam_list_interval
    cam0 = cam_list[0]
    w0, h0 = cam0.resolution
    fx0, fy0 = fov2focal(cam0.fovx, w0), fov2focal(cam0.fovy, h0)
    cx0, cy0 = w0 // 2, h0 // 2

    points_original, points_refined = [], []
    for idx in range(start, len(cam_list), cam_list_interval):
        cam = cam_list[idx]
        if mask_areas[idx] <= 0:
            print(f"Camera {idx} has no area on the input image, skipping...")
            continue

        # auto-upscale the render until the proxy covers enough pixels
        for scale_idx in range(4):
            if scale_idx > 0:
                cam.scale_resolution(1.5)
            pkg = _render_np(cam, gaussian_refined, bg, dev)
            mask_r = pkg["render_alpha"] > 0.0
            if mask_r.sum() > mask_areas[idx] / 10:
                break
        if mask_r.sum() <= 0:
            print(f"Camera {idx} has no area on the rendered image, skipping...")
            cam.restore_resolution()
            continue

        depth_r = pkg["render_depth"] * mask_r
        img_r_crop, depth_r_crop, xxyy_r = crop_with_alpha(
            pkg["render"], mask_r.astype(np.float32), depth_r, border=200
        )

        img_o_pil = _to_pil(mask_images_crop[idx])
        img_r_pil = _to_pil(img_r_crop)
        uv0, uv1 = matcher(
            img_o_pil, img_r_pil, n_points_per_cam=n_points_per_cam,
            key=f"{iteration}_{idx}",
        )
        if len(uv0) == 0:
            cam.restore_resolution()
            continue

        depth_o_np = np.squeeze(mask_depthes_crop[idx])
        depth_r_np = np.squeeze(depth_r_crop)
        d_o = depth_o_np[uv0[:, 1], uv0[:, 0]]
        d_r = depth_r_np[uv1[:, 1], uv1[:, 0]]
        nz = (d_o > 0) & (d_r > 0)
        uv0, uv1, d_o, d_r = uv0[nz], uv1[nz], d_o[nz], d_r[nz]

        w_r, h_r = cam.resolution
        fx_r, fy_r = fov2focal(cam.fovx, w_r), fov2focal(cam.fovy, h_r)
        cx_r, cy_r = w_r // 2, h_r // 2

        uv0_full = restore_coords(uv0, mask_bbox_xxyys[idx])
        uv1_full = restore_coords(uv1, xxyy_r)
        pts_o_cam = pix2pcd(uv0_full, d_o, fx0, fy0, cx0, cy0)
        pts_r_cam = pix2pcd(uv1_full, d_r, fx_r, fy_r, cx_r, cy_r)

        R_c2w = cam.R
        t_c2w = -R_c2w @ cam.T
        points_original.append(pts_o_cam @ R_c2w.T + t_c2w)
        points_refined.append(pts_r_cam @ R_c2w.T + t_c2w)

        if visual_match_save_path:
            show_feature_matches(
                uv0, uv1, img_o_pil, img_r_pil,
                os.path.join(visual_match_save_path, f"{iteration}_{idx}.png"),
            )
        print(f"{idx}th camera done. {nz.sum()} points found.", end="\r")
        cam.restore_resolution()

    if not points_original:
        raise RuntimeError("No correspondence points found in any camera")
    return np.concatenate(points_original), np.concatenate(points_refined)


def align(
    dataset: ModelParams,
    pipeline: PipelineParams,
    object_name: str,
    num_iterations: int = 6,
    opt_12dof_iterations=(3,),
    cam_list_interval: int = 10,
    rotations_path: str = "rotation_matrices",
    visual_match: bool = False,
    matcher_backend: str = "auto",
    scene_render=None,
    matcher_kwargs: dict | None = None,
    device: str | torch.device = "cuda",
):
    """`scene_render(cam, gaussians, bg) -> dict` renders the SCENE object's
    depth (3DGS on `device` by default; the 2DGS twin passes a surfel
    renderer)."""
    dev = resolve_device(device)
    if scene_render is None:
        def scene_render(cam, gaussians, bg):
            return _render_np(cam, gaussians, bg, dev)
    rotations_list = load_rotation_bank(rotations_path, 64) if rotations_path else None

    scene = Scene(dataset, shuffle=False, load_gaussians=False)
    gaussian_original = load_gaussian_ply(
        os.path.join(dataset.model_path, "gs_seg", f"{object_name}.ply"),
        max_sh_degree=dataset.sh_degree,
    )
    gaussian_refined = load_gaussian_ply(
        os.path.join(dataset.model_path, "generated", f"{object_name}.ply"),
        max_sh_degree=0,
    )
    bg = np.array([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                  np.float32)
    matcher = get_matcher(matcher_backend, device=dev, **(matcher_kwargs or {}))

    cam_list = list(scene.get_train_cameras())
    rgba_dir = os.path.join(dataset.source_path, "masked_image_rgba")
    assert os.path.exists(rgba_dir), f"RGBA directory {rgba_dir} does not exist"
    cam_list_interval = int(np.ceil(len(cam_list) / 15))

    # precompute per-camera masked crops + scene-object depth renders
    print("Loading RGBA...")
    mask_areas, mask_images, mask_depthes, xxyys = [], [], [], []
    for cam in cam_list:
        rgba_path = os.path.join(rgba_dir, object_name, f"{cam.image_name}.png")
        with Image.open(rgba_path) as pil:
            rgba = np.asarray(pil.resize(cam.resolution), np.float32).transpose(2, 0, 1) / 255.0
        mask = (rgba[3:4] > 0).astype(np.float32)
        area = float(mask.sum())
        if area > 0:
            image = rgba[:3] * mask
            pkg = scene_render(cam, gaussian_original, bg)
            depth = pkg["render_depth"] * mask
            img_crop, depth_crop, xxyy = crop_with_alpha(image, mask, depth, border=200)
            xxyys.append(xxyy)
            mask_areas.append(area)
            mask_images.append(img_crop)
            mask_depthes.append(depth_crop)
        else:
            xxyys.append(None)
            mask_areas.append(0.0)
            mask_images.append(None)
            mask_depthes.append(None)

    aligned_dir = os.path.join(dataset.model_path, "generated_aligned")
    os.makedirs(aligned_dir, exist_ok=True)

    # ---- coarse init: bbox-ratio scale + centroid shift + multi-init ICP ----
    pc_o = gaussian_original.xyz.astype(np.float32)
    pc_r = gaussian_refined.xyz.astype(np.float32)
    bbox_o = pc_o.max(axis=0) - pc_o.min(axis=0)
    bbox_r = pc_r.max(axis=0) - pc_r.min(axis=0)
    scale_bbox = float(np.prod(bbox_o / bbox_r) ** (1.0 / 3.0))
    threshold_matching = float(bbox_o.mean() / 10.0)

    apply_scale(gaussian_refined, scale_bbox)
    translation_pre = get_centroid(pc_o, "mean") - get_centroid(pc_r, "mean")
    apply_transformation(gaussian_refined, np.eye(3), translation_pre)

    if rotations_list is not None:
        T = best_icp_transform(
            pc_o, gaussian_refined.xyz.astype(np.float32),
            rotations_list, threshold=threshold_matching * 1.6, device=dev,
        )
        apply_transformation(gaussian_refined, T[:3, :3], T[:3, 3])

    visual_dir = None
    if visual_match:
        visual_dir = os.path.join(dataset.model_path, "visual_match", object_name)
        shutil.rmtree(visual_dir, ignore_errors=True)
        os.makedirs(visual_dir)

    # ---- iterative render-match-solve ----
    for it in range(num_iterations):
        try:
            pcd_o, pcd_r = get_pcd_pair(
                gaussian_refined, cam_list, bg, matcher,
                mask_images, mask_depthes, mask_areas, xxyys,
                iteration=it, n_points_per_cam=16,
                cam_list_interval=cam_list_interval,
                visual_match_save_path=visual_dir, device=dev,
            )
            if len(pcd_o) < 3:
                raise RuntimeError("fewer than 3 correspondences")
        except RuntimeError as e:
            print(f"[iter {it}] matching produced no usable correspondences ({e}); "
                  "keeping current alignment")
            save_gaussian_ply(
                os.path.join(aligned_dir, f"{object_name}_{it}.ply"), gaussian_refined
            )
            continue

        R_org = None
        if it in opt_12dof_iterations:
            R, t, s, R_org = adam_algorithm_3d3d_9dof(
                pcd_r, pcd_o, iterations=3000, verbose_interval=200, device=dev,
            )
        else:
            R, t, s = pc_align_ransac(pcd_r, pcd_o, threshold=threshold_matching, device=dev)

        # anisotropic scale applies in the orthogonal frame
        if R_org is not None:
            apply_transformation(gaussian_refined, R_org, [0.0, 0.0, 0.0])
        apply_scale(gaussian_refined, s)
        if R_org is not None:
            apply_transformation(gaussian_refined, R_org.T, [0.0, 0.0, 0.0])
        apply_transformation(gaussian_refined, R, t)

        path = os.path.join(aligned_dir, f"{object_name}_{it}.ply")
        save_gaussian_ply(path, gaussian_refined)
        print(f"Aligned object saved to {path}")

    path = os.path.join(aligned_dir, f"{object_name}.ply")
    save_gaussian_ply(path, gaussian_refined)
    print(f"Aligned object saved to {path}")
    return gaussian_refined


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
    parser.add_argument("--name", type=str, default="None",
                        help="name of the object to replace")
    parser.add_argument("--rotations_dir", default="rotation_matrices", type=str)
    parser.add_argument("--matcher", default="auto", type=str,
                        help="feature matcher backend: auto|mast3r|sift|orb|precomputed")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render and solve on (default cuda; cpu "
                             "runs the kernels' plain PyTorch versions)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)
    dataset = ModelParams.extract(args).finalize()

    description_path = os.path.join(dataset.source_path, "description.yml")
    if not os.path.exists(description_path):
        raise FileNotFoundError(f"Config file not found at {description_path}")
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
