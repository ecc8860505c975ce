"""Plain losses and Adam of the 3DGS/2DGS recipe (the reference trainers'
defaults), float32: L1, SSIM (11x11 Gaussian window, sigma 1.5, zero
padding, C1 = 0.01^2, C2 = 0.03^2), the isotropic scale term, and
torch.optim.Adam's update with eps 1e-15 and the per-group learning
rates."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float64, device=img1.device) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = (g / g.sum()).float()
    win = (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()

    def conv(t):
        return F.conv2d(t[None], win, padding=5, groups=3)[0]

    mu1, mu2 = conv(img1), conv(img2)
    s11 = conv(img1 * img1) - mu1 * mu1
    s22 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def photometric(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    return (1 - lambda_dssim) * (image - gt).abs().mean() + lambda_dssim * (1 - ssim(image, gt))


def isotropic(log_scale: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean over live rows and axes of |s - mean over axes of s|, s = exp."""
    s = torch.exp(log_scale)
    iso = (s - s.mean(1, keepdim=True)).abs()
    return torch.where(alive[:, None], iso, 0.0).sum() / (alive.sum().clamp_min(1) * s.shape[1])


def learning_rates(opt: dict, iteration: int) -> dict:
    """Per-group learning rates at `iteration` (the position rate decays
    log-linearly from its initial to its final value over its steps)."""
    t = min(max(iteration / opt["position_lr_max_steps"], 0.0), 1.0)
    xyz = math.exp(math.log(opt["position_lr_init"]) * (1 - t)
                   + math.log(opt["position_lr_final"]) * t)
    return {"xyz": xyz, "f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"]}


def adam(params: dict, grads: dict, m: dict, v: dict, step: int, lrs: dict):
    """One Adam step (step = the count after it) -> (params, m, v)."""
    bc1 = 1 - ADAM_B1 ** step
    bc2 = 1 - ADAM_B2 ** step
    out_p, out_m, out_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mk = ADAM_B1 * m[k] + (1 - ADAM_B1) * g
        vk = ADAM_B2 * v[k] + (1 - ADAM_B2) * g * g
        out_p[k] = p - lrs[k] * (mk / bc1) / (torch.sqrt(vk / bc2) + ADAM_EPS)
        out_m[k], out_v[k] = mk, vk
    return out_p, out_m, out_v
