"""Image losses and metrics, port of `scorp_tpu.ops.losses`.

The reference numerics:
  * l1/l2 over all elements;
  * SSIM with an 11x11 sigma=1.5 Gaussian window, zero padding,
    C1=0.01^2, C2=0.03^2, as two separable 1D passes (the 2D window is an
    outer product, so this is exact). The passes are shift-and-add over a
    zero-padded image in f32: no convolution routine, so no TF32 either;
  * PSNR/MSE per image;
  * the isotropic scaling regularizer;
  * min-max depth normalization with the extrema detached;
  * the patchwise depth loss `random_patch_loss`, its patch corners drawn
    from a torch.Generator (the JAX package's from jax.random).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over [C, H, W] leading-batched inputs -> [C, 1]."""
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


@lru_cache(maxsize=8)
def _gaussian_window_1d(window_size: int, sigma: float) -> tuple[float, ...]:
    vals = [
        math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
        for x in range(window_size)
    ]
    s = sum(vals)
    return tuple(v / s for v in vals)


def _sep_conv2d(img: torch.Tensor, win: tuple[float, ...]) -> torch.Tensor:
    """Depthwise 2D 'SAME' convolution of [C, H, W] with the outer product
    of `win`, zero padded, as two shift-and-add passes (tap order as the
    JAX package's)."""
    pad = len(win) // 2
    _, h, w = img.shape
    x = F.pad(img, (0, 0, pad, pad))
    x = sum(win[i] * x[:, i: i + h, :] for i in range(len(win)))
    x = F.pad(x, (pad, pad))
    return sum(win[i] * x[:, :, i: i + w] for i in range(len(win)))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [C, H, W] images (reference window + padding behavior)."""
    win = _gaussian_window_1d(window_size, 1.5)
    mu1 = _sep_conv2d(img1, win)
    mu2 = _sep_conv2d(img2, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _sep_conv2d(img1 * img1, win) - mu1_sq
    sigma2_sq = _sep_conv2d(img2 * img2, win) - mu2_sq
    sigma12 = _sep_conv2d(img1 * img2, win) - mu1_mu2

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def isotropic_loss(scaling: torch.Tensor) -> torch.Tensor:
    """Mean |s - mean(s)| over the (activated) scaling tensor [N, 3]."""
    return (scaling - scaling.mean(dim=1, keepdim=True)).abs().mean()


def depth_normalize(depth: torch.Tensor) -> torch.Tensor:
    """Min-max normalize; min/max are detached like the reference."""
    min_val = depth.min().detach()
    max_val = depth.max().detach()
    return (depth - min_val) / (max_val - min_val)


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware second-order disparity smoothness."""
    gdx = (disp[:, 1:-1, :-2] + disp[:, 1:-1, 2:] - 2 * disp[:, 1:-1, 1:-1]).abs()
    gdy = (disp[:, :-2, 1:-1] + disp[:, 2:, 1:-1] - 2 * disp[:, 1:-1, 1:-1]).abs()
    gix = (img[:, 1:-1, :-2] - img[:, 1:-1, 2:]).abs().mean(0, keepdim=True) * 0.5
    giy = (img[:, :-2, 1:-1] - img[:, 2:, 1:-1]).abs().mean(0, keepdim=True) * 0.5
    return (gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean()


def pearson_depth_loss(depth_src: torch.Tensor, depth_target: torch.Tensor) -> torch.Tensor:
    """1 - Pearson correlation over [B, h, w] depth batches (population std,
    as jnp.std)."""
    src = depth_src - depth_src.mean(dim=(1, 2), keepdim=True)
    tgt = depth_target - depth_target.mean(dim=(1, 2), keepdim=True)
    src = src / (src.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6)
    tgt = tgt / (tgt.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6)
    return 1.0 - (src * tgt).mean(dim=(1, 2)).mean()


def _patch_loss(depth_src: torch.Tensor, depth_tgt: torch.Tensor, x0: torch.Tensor,
                y0: torch.Tensor, box_p: int, loss_func: str) -> torch.Tensor:
    """random_patch_loss on given patch corners: rows x0.., columns y0.."""
    src = depth_src.squeeze()
    tgt = depth_tgt.squeeze()
    ar = torch.arange(box_p, device=src.device)
    rows = (x0.to(src.device)[:, None] + ar)[:, :, None]  # [n, box, 1]
    cols = (y0.to(src.device)[:, None] + ar)[:, None, :]  # [n, 1, box]
    ps, pt = src[rows, cols], tgt[rows, cols]
    if loss_func == "l1":
        return l1_loss(depth_normalize(ps), depth_normalize(pt))
    if loss_func == "l2":
        return l2_loss(depth_normalize(ps), depth_normalize(pt))
    if loss_func == "pearson":
        return pearson_depth_loss(ps, pt)
    raise ValueError(f"Unknown loss function: {loss_func}")


def random_patch_loss(
    depth_src: torch.Tensor,
    depth_tgt: torch.Tensor,
    box_p: int,
    p_corr: float,
    generator: torch.Generator,
    loss_func: str = "l1",
) -> torch.Tensor:
    """Patchwise normalised depth loss (reference gs2dgs loss_utils.py:
    117-154): p_corr·(H/box)(W/box) random box_p-sized patches, their
    min-max normalised depths compared by `loss_func` (l1, l2 or pearson).
    The corners are uniform in [0, H - box_p) x [0, W - box_p), drawn from
    `generator` (on the depth's device); the JAX package draws them with
    jax.random, so the two streams differ by design."""
    h, w = depth_src.squeeze().shape
    n_corr = int(p_corr * (h // box_p) * (w // box_p))
    x0 = torch.randint(0, h - box_p, (n_corr,), generator=generator, device=generator.device)
    y0 = torch.randint(0, w - box_p, (n_corr,), generator=generator, device=generator.device)
    return _patch_loss(depth_src, depth_tgt, x0, y0, box_p, loss_func)
