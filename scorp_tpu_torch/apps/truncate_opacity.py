"""Opacity truncation of generated proxy Gaussians, port of
`scorp_tpu.apps.truncate_opacity` (the reference's `truncate_opacity.py`
CLI): drop Gaussians whose activated (sigmoid) opacity is below a threshold
from every `generated/*.ply`, rewriting in place with a `.ply.bak` backup.

The work is host-side numpy, as in the JAX package, so the PLYs are the
same bytes. `--device` follows the port's entry-point rule (cuda unless the
caller asks for the CPU) and is checked before any file is touched.

    python -m scorp_tpu_torch.apps.truncate_opacity -m <model> [--threshold 0.1] [--device cuda]
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

import numpy as np

from ..core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
from ..device import resolve_device


def truncate_gs(g: GaussianData, threshold: float = 0.1) -> GaussianData:
    opacity = 1.0 / (1.0 + np.exp(-g.opacity[:, 0]))
    return g.select(~(opacity < threshold))


def truncate(gs_path: str, threshold: float = 0.1) -> GaussianData:
    assert os.path.exists(gs_path), f"Gaussian model file {gs_path} does not exist"
    shutil.copy(gs_path, gs_path + ".bak")
    g = truncate_gs(load_gaussian_ply(gs_path), threshold)
    save_gaussian_ply(gs_path, g)
    return g


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    parser.add_argument("--model_path", "-m", type=str, required=True,
                        help="path to the scene Gaussian model")
    parser.add_argument("--threshold", default=0.1, type=float,
                        help="opacity threshold for truncation")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the entry point's device (default cuda; pass cpu on a "
                             "machine without a GPU); the truncation runs on the host")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    resolve_device(args.device)

    gs_generated_path = os.path.join(args.model_path, "generated")
    if not os.path.exists(gs_generated_path):
        raise FileNotFoundError(
            f"Generated Gaussian model path {gs_generated_path} does not exist"
        )
    kept = {}
    for name in os.listdir(gs_generated_path):
        if name.endswith(".ply"):
            path = os.path.join(gs_generated_path, name)
            kept[path] = truncate(path, args.threshold).n
            print(f"Truncated {path} with threshold {args.threshold}")
    return kept


if __name__ == "__main__":
    main()
