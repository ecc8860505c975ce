"""Proxy generation: selected object RGBA views -> 3D Gaussian proxy, port
of `scorp_tpu.apps.trellis_img2gs` (the reference's `trellis_img2gs.py`
CLI).

Backends:
  * "precomputed" (`--proxy_dir`): copies <obj>.ply proxies from a
    directory;
  * TRELLIS-image-large, which needs its checkpoint and package. Neither is
    in the repository, so without `--proxy_dir` the app raises as the JAX
    app does, and `generate_trellis` raises.

    python -m scorp_tpu_torch.apps.trellis_img2gs -m <model> --proxy_dir <dir> [--device cuda]
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

from ..device import resolve_device

TRELLIS_CKPT = "checkpoints/TRELLIS/TRELLIS-image-large"


def generate_trellis(pipeline, rgba_dir: str, object_name: str, save_dir: str,
                     save_type: str = "gs"):
    raise NotImplementedError(
        "the TRELLIS backend is not ported to scorp_tpu_torch: its checkpoint and "
        "package are not in the repository; pass --proxy_dir with precomputed "
        "<object>.ply proxies"
    )


def generate_precomputed(proxy_dir: str, object_name: str, save_dir: str):
    src = os.path.join(proxy_dir, f"{object_name}.ply")
    if not os.path.exists(src):
        raise FileNotFoundError(
            f"Precomputed proxy {src} not found; provide --proxy_dir with "
            f"<object>.ply files or install TRELLIS + its checkpoint"
        )
    shutil.copy(src, os.path.join(save_dir, f"{object_name}.ply"))
    print(f"Copied precomputed proxy for {object_name}")


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--save_type", type=str, default="gs", help="gs, mesh, both")
    parser.add_argument("--object_name", type=str, default=None)
    parser.add_argument("--proxy_dir", type=str, default=None,
                        help="precomputed-proxy backend: dir of <object>.ply files")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the generator (default cuda; pass cpu on "
                             "a machine without a GPU); the precomputed backend copies "
                             "files on the host")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    resolve_device(args.device)

    rgba_path = os.path.join(args.model_path, "masked_image_rgba_selected")
    assert os.path.exists(rgba_path), f"RGBA path {rgba_path} does not exist"
    save_dir = os.path.join(args.model_path, "generated")
    os.makedirs(save_dir, exist_ok=True)

    objects = [args.object_name] if args.object_name else os.listdir(rgba_path)
    if args.object_name and args.object_name not in os.listdir(rgba_path):
        raise ValueError(f"Object {args.object_name} not found in {rgba_path}")

    if args.proxy_dir is None:
        if not os.path.exists(TRELLIS_CKPT):
            raise RuntimeError(
                f"TRELLIS checkpoint not found at {TRELLIS_CKPT}; either install "
                "it or pass --proxy_dir with precomputed <object>.ply proxies"
            )
        generate_trellis(None, rgba_path, objects[0], save_dir, args.save_type)

    for object_name in objects:
        print(f"Processing {object_name}")
        generate_precomputed(args.proxy_dir, object_name, save_dir)
    return objects


if __name__ == "__main__":
    main()
