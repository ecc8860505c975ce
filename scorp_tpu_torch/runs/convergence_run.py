"""30k-iteration 3DGS convergence run on a kitchen-scale synthetic scene,
port of the JAX package's `scripts/convergence_run.py`.

Builds a COLMAP dataset (ground truth: 40k clustered gaussians in a closed
room, rendered at 800x600 from an orbit of 96 cameras through `render`),
then runs `apps.train_3dgs` with the script's arguments (`--eval`, test
evaluations at 7k / 15k / 30k) and prints the run's JSON summary line.

    python -m scorp_tpu_torch.runs.convergence_run [outdir] [--iters N] [--device cuda]

The scene is built once per outdir (kept while `<outdir>/scene/split.yml`
exists). Arguments after `--` go to the trainer unchanged.
"""

from __future__ import annotations

import json
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch
import yaml
from PIL import Image

from ..apps import train_3dgs
from ..core import colmap
from ..core.camera import fov2focal, make_camera
from ..core.plyio import GaussianData
from ..core.sh import rgb_to_sh
from ..device import resolve_device
from ..ops.raster import RasterConfig
from ..render import regrow_config, render
from ..train.state import from_gaussian_data
from .summary import eval_iterations, final_ply, split_trainer_args, summarize, train

# the JAX scripts render their ground truth at this key capacity and never
# read the dropped count; `write_scene` starts every view there
JAX_GT_MAX_KEYS = 1 << 21


def make_scene_gaussians(n=40_000, seed=7):
    """The JAX script's scene, draw for draw: a closed room of wall slabs
    (cameras orbit inside it) with 24 furniture clusters of large gaussians,
    smooth wall colours and per-object base colours."""
    rng = np.random.default_rng(seed)
    n_wall = (3 * n) // 5
    walls = []
    slabs = ((0, -2.6), (0, 2.6), (1, -1.6), (1, 1.6), (2, -2.6), (2, 2.6))
    for axis, offset in slabs:
        p = rng.uniform(-2.6, 2.6, size=(n_wall // 6, 3))
        p[:, 1] = np.clip(p[:, 1], -1.6, 1.6)
        p[:, axis] = offset + rng.normal(0, 0.02, len(p))
        walls.append(p)
    walls = np.concatenate(walls)[:n_wall]
    n_obj = 24
    centers = rng.uniform(-1.1, 1.1, size=(n_obj, 3)) * np.array([1, 0.55, 1])
    idx = rng.integers(0, n_obj, size=n - n_wall)
    clutter = centers[idx] + rng.normal(0, 0.16, size=(n - n_wall, 3))
    xyz = np.concatenate([walls, clutter]).astype(np.float32)
    n = len(xyz)
    freqs = rng.normal(0, 1.0, size=(3, 3))
    phases = rng.uniform(0, 2 * np.pi, size=3)
    colors = 0.5 + 0.3 * np.sin(xyz @ freqs.T + phases)
    obj_colors = rng.uniform(0.15, 0.85, size=(n_obj, 3))
    colors[n_wall:] = obj_colors[idx]
    colors = np.clip(colors + rng.normal(0, 0.02, size=(n, 3)), 0.05, 0.95)
    colors = colors.astype(np.float32)
    k = 16
    f_rest = rng.normal(0, 0.004, size=(n, k - 1, 3)).astype(np.float32)
    scaling = np.concatenate([
        rng.normal(np.log(0.055), 0.3, size=(n_wall, 3)),
        rng.normal(np.log(0.085), 0.3, size=(n - n_wall, 3)),
    ])
    return GaussianData(
        xyz=xyz,
        f_dc=rgb_to_sh(colors).reshape(n, 1, 3).astype(np.float32),
        f_rest=f_rest,
        opacity=rng.normal(2.6, 0.6, size=(n, 1)).astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
    )


def orbit_pose(angle, radius, height):
    """(C2W rotation, W2C translation) of a camera at `angle` on the orbit,
    looking at the origin."""
    eye = np.array([radius * np.sin(angle), height, -radius * np.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)
    T_w2c = -R_c2w.T @ eye
    return R_c2w, T_w2c


def write_scene(root, g: GaussianData, *, n_views, width, height, fov, seed, n_init,
                device="cuda") -> dict:
    """The JAX scripts' dataset layout from the gaussians `g`: images/*.png
    (ground truth rendered on `device`, uint8-quantised), the three COLMAP
    binaries, an SfM-like init of `n_init` noisy gaussian centres and
    split.yml (every 12th view for test).

    Each view renders first at the JAX scripts' key capacity, and again with
    doubled capacities until it drops no key, so every image is complete.
    Returns the per-view dropped keys at the JAX capacity and in the
    written image, the number of renders, the largest key capacity used,
    the build's seconds and the device state that was rendered."""
    t0 = time.time()
    dev = resolve_device(device)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "sparse"), exist_ok=True)
    state = from_gaussian_data(g, device=dev)
    bg = torch.zeros(3, device=dev)
    cams, imgs, names = {}, {}, []
    rng = np.random.default_rng(seed + 3)
    dropped_at_jax_capacity, dropped_final, renders, max_keys = [], [], 0, JAX_GT_MAX_KEYS
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        # inside the closed room (walls at +-2.6, ceiling +-1.6)
        radius = 1.8 + 0.25 * np.sin(3 * a)
        height_i = 0.15 + 0.45 * np.sin(2 * a + 1)
        R_c2w, T_w2c = orbit_pose(a, radius, height_i)
        cam = make_camera(R_c2w, T_w2c, fov, fov * height / width * 1.0, width, height,
                          device=dev)
        cfg = RasterConfig(max_keys=JAX_GT_MAX_KEYS)
        with torch.no_grad():
            while True:
                out = render(cam, state, bg, sh_degree=3, cfg=cfg)
                renders += 1
                dropped = int(out["num_dropped_keys"])
                if cfg.max_keys == JAX_GT_MAX_KEYS:
                    dropped_at_jax_capacity.append(dropped)
                if not dropped:
                    break
                cfg = regrow_config(cfg, dropped)
        dropped_final.append(dropped)
        max_keys = max(max_keys, cfg.max_keys)
        img = (np.clip(out["render"].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        name = f"img_{i:03d}"
        names.append(name)
        Image.fromarray(img.transpose(1, 2, 0)).save(
            os.path.join(root, "images", name + ".png"))
        qvec = colmap.rotmat2qvec(R_c2w.T)
        imgs[i + 1] = colmap.ColmapImage(
            i + 1, qvec, T_w2c, 1, name + ".png", np.zeros((0, 2)),
            np.zeros(0, np.int64))
    focal = fov2focal(fov, width)
    focal_y = fov2focal(fov * height / width, height)
    cams[1] = colmap.ColmapCamera(
        1, "PINHOLE", width, height,
        np.array([focal, focal_y, width / 2, height / 2]))
    colmap.write_intrinsics_binary(cams, os.path.join(root, "sparse", "cameras.bin"))
    colmap.write_extrinsics_binary(imgs, os.path.join(root, "sparse", "images.bin"))
    # sparse init: subsample GT centres with noise (SfM-like)
    sel = rng.choice(len(g.xyz), size=n_init, replace=False)
    pts = g.xyz[sel] + rng.normal(0, 0.03, (len(sel), 3))
    rgb = (rng.uniform(0.2, 0.8, (len(pts), 3)) * 255).astype(np.uint8)
    colmap.write_points3D_binary(pts, rgb, np.zeros((len(pts), 1)),
                                 os.path.join(root, "sparse", "points3D.bin"))
    test_names = names[::12]
    train_names = [nm for nm in names if nm not in test_names]
    with open(os.path.join(root, "split.yml"), "w") as f:
        yaml.safe_dump({"train": train_names, "test": test_names}, f)
    return {"views": n_views, "renders": renders, "max_keys": max_keys,
            "dropped_at_jax_capacity": dropped_at_jax_capacity, "dropped_final": dropped_final,
            "seconds": time.time() - t0, "state": state}


def build_dataset(root, n_views=96, width=800, height=600, fov=1.1, seed=7, n=40_000,
                  n_init=25_000, device="cuda") -> dict:
    info = write_scene(root, make_scene_gaussians(n=n, seed=seed), n_views=n_views,
                       width=width, height=height, fov=fov, seed=seed, n_init=n_init,
                       device=device)
    print(f"dataset ready: {n_views} views at {width}x{height} in {info['seconds']:.1f} s; "
          f"views dropping keys at {JAX_GT_MAX_KEYS} key slots: "
          f"{sum(d > 0 for d in info['dropped_at_jax_capacity'])}")
    return info


def main(argv=None):
    own, trainer_extra = split_trainer_args(list(sys.argv[1:] if argv is None else argv))
    ap = ArgumentParser(description="3DGS convergence run on a synthetic room scene")
    ap.add_argument("outdir", nargs="?", default=os.path.join("build", "runs", "convergence"))
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(own)
    device = resolve_device(args.device)
    scene_dir = os.path.join(args.outdir, "scene")
    model_dir = os.path.join(args.outdir, "model")
    if not os.path.exists(os.path.join(scene_dir, "split.yml")):
        build_dataset(scene_dir, device=device)

    tests = eval_iterations((7000, 15000, 30000), args.iters)
    trainer_argv = [
        "-s", scene_dir, "-m", model_dir, "--eval", "--quiet",
        "--split_yml_name", "split.yml",
        "--iterations", str(args.iters),
        "--test_iterations", *[str(i) for i in tests],
        "--save_iterations", str(args.iters),
        "--device", str(device), *trainer_extra,
    ]
    result, wall = train(train_3dgs.main, trainer_argv, device)
    print(f"total wall-clock: {wall:.0f}s")
    summary = summarize("convergence_run", result[3], result[1],
                        final_ply(model_dir, args.iters), args.iters, wall, device)
    print(json.dumps(summary))
    return summary, result


if __name__ == "__main__":
    main()
