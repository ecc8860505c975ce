"""Densification-at-scale 3DGS run, port of the JAX package's
`scripts/densify_scale_run.py`.

The convergence run's smooth room converges to ~1.3k gaussians, so it never
drives densification at realistic N. This run's scene is fine-grained but
fittable: 200k small, near-opaque ground-truth gaussians on the same closed
room (multi-octave sinusoid wall texture, per-object checker), seen from an
8k-point SfM-like init, so fitting it needs ~25-50x growth through several
capacity growths and opacity resets under the trainer's own densification
protocol (every 100 iterations from 500 to 25,000, opacity reset every
3,000).

    python -m scorp_tpu_torch.runs.densify_scale_run [outdir] [--iters N] \\
        [--grad_threshold 1e-4] [--pilot] [--device cuda]

`--pilot` caps the run at 3,000 iterations and trains with `--quiet`.
After the summary line the run checks the final PLY: every position
finite, and (outside the pilot) at least 100,000 gaussians. Arguments after
`--` go to the trainer unchanged.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np

from ..apps import train_3dgs
from ..core.plyio import GaussianData, load_gaussian_ply
from ..core.sh import rgb_to_sh
from ..device import resolve_device
from .convergence_run import JAX_GT_MAX_KEYS, write_scene
from .summary import eval_iterations, final_ply, split_trainer_args, summarize, train

PILOT_ITERS = 3000
MIN_FINAL_GAUSSIANS = 100_000


def make_textured_gaussians(n=200_000, seed=11):
    """The JAX script's scene, draw for draw: the convergence run's closed
    room with thinner walls, four sinusoid octaves up to ~60 rad/unit on
    the walls, a 24/unit checker on the furniture, and small gaussians."""
    rng = np.random.default_rng(seed)
    n_wall = (3 * n) // 4
    walls = []
    slabs = ((0, -2.6), (0, 2.6), (1, -1.6), (1, 1.6), (2, -2.6), (2, 2.6))
    for axis, offset in slabs:
        p = rng.uniform(-2.6, 2.6, size=(n_wall // 6, 3))
        p[:, 1] = np.clip(p[:, 1], -1.6, 1.6)
        p[:, axis] = offset + rng.normal(0, 0.01, len(p))
        walls.append(p)
    walls = np.concatenate(walls)[:n_wall]
    n_obj = 24
    centers = rng.uniform(-1.1, 1.1, size=(n_obj, 3)) * np.array([1, 0.55, 1])
    idx = rng.integers(0, n_obj, size=n - n_wall)
    clutter = centers[idx] + rng.normal(0, 0.16, size=(n - n_wall, 3))
    xyz = np.concatenate([walls, clutter]).astype(np.float32)
    n = len(xyz)

    col = np.full((n, 3), 0.5, np.float32)
    for fscale, amp in ((2.0, 0.16), (8.0, 0.14), (24.0, 0.14), (60.0, 0.22)):
        freqs = rng.normal(0, fscale, size=(3, 3))
        phases = rng.uniform(0, 2 * np.pi, size=3)
        col += amp * np.sin(xyz @ freqs.T + phases).astype(np.float32)
    obj_colors = rng.uniform(0.2, 0.8, size=(n_obj, 3)).astype(np.float32)
    checker = (np.floor(xyz[n_wall:] * 24.0).sum(axis=1) % 2).astype(np.float32)
    col[n_wall:] = obj_colors[idx] * (0.65 + 0.7 * checker[:, None])
    col = np.clip(col, 0.05, 0.95).astype(np.float32)

    scaling = np.concatenate([
        rng.normal(np.log(0.016), 0.25, size=(n_wall, 3)),
        rng.normal(np.log(0.022), 0.25, size=(n - n_wall, 3)),
    ])
    return GaussianData(
        xyz=xyz,
        f_dc=rgb_to_sh(col).reshape(n, 1, 3).astype(np.float32),
        f_rest=rng.normal(0, 0.003, size=(n, 15, 3)).astype(np.float32),
        opacity=rng.normal(3.2, 0.4, size=(n, 1)).astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
    )


def build_dataset(root, n_views=96, width=800, height=600, fov=1.1, seed=11,
                  n_init=8_000, n=200_000, device="cuda") -> dict:
    g = make_textured_gaussians(n=n, seed=seed)
    info = write_scene(root, g, n_views=n_views, width=width, height=height, fov=fov,
                       seed=seed, n_init=n_init, device=device)
    print(f"dataset ready: {n_views} views at {width}x{height}, init {n_init} pts, "
          f"GT {g.n} gaussians, in {info['seconds']:.1f} s; views dropping keys at "
          f"{JAX_GT_MAX_KEYS} key slots: "
          f"{sum(d > 0 for d in info['dropped_at_jax_capacity'])}")
    return info


def main(argv=None):
    own, trainer_extra = split_trainer_args(list(sys.argv[1:] if argv is None else argv))
    ap = ArgumentParser(description="3DGS densification-at-scale run on a synthetic room")
    ap.add_argument("outdir", nargs="?", default=os.path.join("build", "runs", "densify"))
    ap.add_argument("--iters", type=int, default=30_000)
    # the reference's own hyperparameter; its 2e-4 default grows ~1% per
    # round on this scene, too slow to reach 1e5 gaussians in the window
    ap.add_argument("--grad_threshold", type=str, default=None)
    ap.add_argument("--pilot", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(own)
    device = resolve_device(args.device)
    iters = min(args.iters, PILOT_ITERS) if args.pilot else args.iters
    scene_dir = os.path.join(args.outdir, "scene")
    model_dir = os.path.join(args.outdir, "model")
    if not os.path.exists(os.path.join(scene_dir, "split.yml")):
        build_dataset(scene_dir, device=device)

    tests = eval_iterations((3000, 7000, 15000, 30000), iters)
    trainer_argv = [
        "-s", scene_dir, "-m", model_dir, "--eval",
        "--split_yml_name", "split.yml",
        "--iterations", str(iters),
        "--test_iterations", *[str(i) for i in tests],
        "--save_iterations", str(iters),
        "--device", str(device),
    ]
    if args.pilot:
        trainer_argv.append("--quiet")  # full runs keep the eval PSNR prints
    if args.grad_threshold is not None:
        trainer_argv += ["--densify_grad_threshold", args.grad_threshold]
    result, wall = train(train_3dgs.main, trainer_argv + trainer_extra, device)
    print(f"total wall-clock: {wall:.0f}s ({iters / wall:.2f} it/s)")
    ply = final_ply(model_dir, iters)
    summary = summarize("densify_scale_run", result[3], result[1], ply, iters, wall, device)
    print(json.dumps(summary))

    g = load_gaussian_ply(ply)
    if not np.isfinite(g.xyz).all():
        raise RuntimeError(f"non-finite positions in {ply}")
    if not args.pilot and g.n < MIN_FINAL_GAUSSIANS:
        raise RuntimeError(f"densification underdrove the scene: {g.n} < "
                           f"{MIN_FINAL_GAUSSIANS} gaussians at iteration {iters}")
    return summary, result


if __name__ == "__main__":
    main()
