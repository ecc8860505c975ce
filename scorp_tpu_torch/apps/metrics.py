"""Image-quality evaluation: PSNR / SSIM / LPIPS over rendered vs
ground-truth image directories, port of `scorp_tpu.apps.metrics`.

    python -m scorp_tpu_torch.apps.metrics --pred <dir> --gt <dir> [--use_alpha] [--device cuda]

PSNR and SSIM are the port's `ops.losses` (the reference's numerics). LPIPS
resolves as the JAX app's does: a weight file (--lpips_weights, else
$SCORP_LPIPS_WEIGHTS or ~/.cache/scorp_tpu/lpips_vgg.npz) driving
`ops.perceptual.lpips`; else the `lpips` torch package if installed; else
the bundled `lpips_proxy`, reported under that name, never as `lpips`.
Everything runs on `--device` (cuda unless told otherwise; without a GPU it
raises).
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device
from ..ops import perceptual
from ..ops.losses import psnr as psnr_fn
from ..ops.losses import ssim as ssim_fn


def _load(path: str, size=None) -> tuple[np.ndarray, np.ndarray | None]:
    with Image.open(path) as img:
        if size is not None and img.size != size:
            img = img.resize(size)
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    alpha = arr[..., 3] if arr.shape[-1] == 4 else None
    return arr[..., :3].transpose(2, 0, 1), alpha


class LPIPSBackend:
    """Calibrated LPIPS when weights are reachable, the proxy otherwise.

    Resolution order: (1) a weight file (`weights_path`, else
    $SCORP_LPIPS_WEIGHTS / ~/.cache/scorp_tpu/lpips_vgg.npz) driving
    `ops.perceptual.lpips`; (2) the `lpips` torch package if installed with
    its weights; (3) the bundled `lpips_proxy` (reported under that name).
    Calls take [3, H, W] tensors on `device`."""

    def __init__(self, weights_path: str | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        path = weights_path or perceptual.default_lpips_weights_path()
        if path:
            weights = perceptual.lpips_weights_to(perceptual.load_lpips_weights(path),
                                                  self.device)  # raises on a bad file
            self._fn = lambda a, b: perceptual.lpips(a, b, weights)
            self.name = "lpips"
            return
        try:
            import lpips  # type: ignore

            net = lpips.LPIPS(net="vgg").to(self.device)
            self._fn = lambda a, b: net(a[None] * 2 - 1, b[None] * 2 - 1)
            self.name = "lpips"
        except Exception:
            self._fn = perceptual.lpips_proxy
            self.name = "lpips_proxy"

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> float:
        with torch.no_grad():
            return float(self._fn(a.to(torch.float32), b.to(torch.float32)))


def evaluate_dirs(pred_dir: str, gt_dir: str, use_alpha: bool = False,
                  lpips_weights: str | None = None,
                  device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    names = sorted(
        n for n in os.listdir(pred_dir) if n.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not names:
        raise FileNotFoundError(f"no images in {pred_dir}")
    lp = LPIPSBackend(lpips_weights, dev)
    psnrs, ssims, lpipss = [], [], []
    for name in names:
        gt_path = os.path.join(gt_dir, name)
        if not os.path.exists(gt_path):
            base = name.rsplit(".", 1)[0]
            cands = [f for f in os.listdir(gt_dir) if f.rsplit(".", 1)[0] == base]
            if not cands:
                print(f"skipping {name}: no ground truth")
                continue
            gt_path = os.path.join(gt_dir, cands[0])
        pred, pred_a = _load(os.path.join(pred_dir, name))
        gt, gt_a = _load(gt_path, size=(pred.shape[2], pred.shape[1]))
        if use_alpha and (pred_a is not None or gt_a is not None):
            alpha = pred_a if pred_a is not None else gt_a
            pred = pred * alpha[None]
            gt = gt * alpha[None]
        tp = torch.as_tensor(pred, device=dev)
        tg = torch.as_tensor(gt, device=dev)
        psnrs.append(float(psnr_fn(tp, tg).mean()))
        ssims.append(float(ssim_fn(tp, tg)))
        lpipss.append(lp(tp, tg))
    return {
        "n_images": len(psnrs),
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        # keyed by backend: calibrated `lpips` or the bundled random-feature
        # `lpips_proxy` stand-in, never conflated
        lp.name: float(np.mean(lpipss)) if lpipss else None,
        "lpips_backend": lp.name,
    }


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--pred", type=str, required=True)
    parser.add_argument("--gt", type=str, required=True)
    parser.add_argument("--use_alpha", action="store_true",
                        help="mask both images by the prediction's alpha")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="LPIPS-VGG weight file (.npz or torch state_dict); "
                             "default $SCORP_LPIPS_WEIGHTS or "
                             "~/.cache/scorp_tpu/lpips_vgg.npz")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs everything there)")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    result = evaluate_dirs(args.pred, args.gt, args.use_alpha,
                           lpips_weights=args.lpips_weights, device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
