"""The 3DGS training step, port of `scorp_tpu.train.step`.

One call covers the hot loop of the reference trainer: render -> photometric
+ depth + isotropic losses -> backward through the differentiable
rasterizer (kernels K1, K2 and the backward compositor K3 on CUDA tensors)
-> per-group Adam -> densification statistics.

Loss recipe (the reference's OptimizationParams defaults):
  loss = (1-λ_dssim)·L1 + λ_dssim·(1-SSIM)
       + [iter > depth_from_iter] · ( λ_sensor·L1(depth | 0.3<d<7, rend>0)
                                    + 10·w(iter)·L1(minmax-norm depths | masked)
                                    + λ_iso·isotropic(scaling) )
with w(iter) log-lerped 0.25 -> 0.075 over the run. Before depth_from_iter
the depth terms are skipped, not multiplied by zero: they read only the
render, and their gradient is zero either way. The isotropic term reads the
scaling itself, so it is formed at every step and multiplied by the zero
warm-up weight, as the JAX step does: an overflowing scale (exp to inf)
then makes the loss NaN at that step in both packages.

The screen-space densification gradient is the gradient of a zero NDC
offset added to the projected means (`screen_deltas`), the reference's
`screenspace_points.retain_grad()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..ops.losses import l1_loss, ssim
from ..ops.raster import RasterConfig, rasterize
from .densify import accumulate_stats
from .state import AdamState, GaussianState, adam_update, expon_lr


@dataclass(frozen=True)
class OptParams:
    """Optimization hyperparameters (reference defaults)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_depth_sensor: float = 1.5
    lambda_isotropic: float = 0.0005
    opacity_cull: float = 0.6
    max_screen_size: float = 0.5
    depth_from_iter: int = 7000
    dn_l1_weight_init: float = 0.25
    dn_l1_weight_final: float = 0.075
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = True
    spatial_lr_scale: float = 1.0  # forced to 1.0 as the reference's gaussian model does


class StepMetrics(NamedTuple):
    """Device scalars: reading one waits for the step."""

    loss: torch.Tensor
    l1: torch.Tensor
    depth_loss: torch.Tensor
    psnr: torch.Tensor
    num_dropped_keys: torch.Tensor
    num_dropped_tail: torch.Tensor
    num_alive: torch.Tensor


def _masked_mean(x, mask):
    return torch.where(mask, x, 0.0).sum() / torch.clamp_min(mask.to(x.dtype).sum(), 1.0)


def isotropic(scaling: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean over alive rows and axes of |s - mean_axes(s)|, s = exp(scaling)."""
    s = torch.exp(scaling)
    iso = (s - s.mean(dim=1, keepdim=True)).abs()
    n_alive = torch.clamp_min(alive.to(torch.float32).sum(), 1.0)
    return torch.where(alive[:, None], iso, 0.0).sum() / (n_alive * s.shape[1])


def _masked_minmax_normalize(x, mask):
    big = 3.0e38
    mn = torch.where(mask, x, big).min().detach()
    mx = torch.where(mask, x, -big).max().detach()
    return (x - mn) / torch.clamp_min(mx - mn, 1e-8)


def compute_lrs(opt: OptParams, iteration: int) -> dict[str, float]:
    return {
        "xyz": expon_lr(
            float(iteration),
            opt.position_lr_init * opt.spatial_lr_scale,
            opt.position_lr_final * opt.spatial_lr_scale,
            opt.position_lr_max_steps,
            lr_delay_mult=opt.position_lr_delay_mult,
        ),
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
    }


def train_step(
    state: GaussianState,
    adam: AdamState,
    cam: Camera,
    gt_image: torch.Tensor,       # [3, H, W]
    gt_depth_cam: torch.Tensor,   # [1, H, W] (zeros if absent)
    gt_depth_est: torch.Tensor,   # [1, H, W] (zeros if absent)
    iteration: int,               # 1-based
    bg: torch.Tensor,             # [3]
    freeze_rows: int = 0,         # zero the grads of the first K rows (2DGS tuning mask)
    *,
    opt: OptParams,
    sh_degree: int,
    cfg: RasterConfig,
    has_depth_cam: bool = False,
    has_depth_est: bool = False,
    frozen: tuple[str, ...] = (),
    stage_hook=None,
):
    """One step on the camera's device -> (state, adam, StepMetrics). The
    inputs are not modified: the step returns new parameter, moment and
    statistics tensors (at 250k gaussians they are ~60 MB in all, so
    updating in place would save little). `stage_hook`, if given, is called
    with "forward" once the loss is formed and with "backward" once the
    gradients are, e.g. to record CUDA events between the three parts."""
    alive = state.alive
    cap = state.capacity
    dev = alive.device
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    deltas = torch.zeros(cap, 2, device=dev, requires_grad=True)

    out = rasterize(
        params["xyz"],
        torch.sigmoid(params["opacity"][:, 0]),
        cam,
        bg,
        shs=torch.cat([params["f_dc"], params["f_rest"]], dim=1),
        sh_degree=sh_degree,
        scales=torch.exp(params["scaling"]),
        quats=params["rotation"],
        screen_deltas=deltas,
        alive=alive,
        cfg=cfg,
    )
    image = out.color
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim(image, gt_image))

    depth_loss = torch.zeros((), device=dev)
    if iteration > opt.depth_from_iter:
        one = torch.ones((), device=dev)
        rend_depth = out.depth_accum / torch.where(out.alpha == 0.0, one, out.alpha)
        rend_depth = torch.nan_to_num(rend_depth, nan=0.0, posinf=0.0, neginf=0.0)
        if has_depth_cam:
            m = (gt_depth_cam > 0.3) & (gt_depth_cam < 7.0) & (rend_depth > 0.0)
            depth_loss = depth_loss + opt.lambda_depth_sensor * _masked_mean(
                (rend_depth - gt_depth_cam).abs(), m)
        if has_depth_est:
            w = expon_lr(float(iteration), opt.dn_l1_weight_init, opt.dn_l1_weight_final,
                         opt.iterations)
            m = (rend_depth > 0.0) & (gt_depth_est > 0.0)
            pn = _masked_minmax_normalize(gt_depth_est, m)
            rn = _masked_minmax_normalize(rend_depth, m)
            depth_loss = depth_loss + 10.0 * w * _masked_mean((rn - pn).abs(), m)
    if opt.lambda_isotropic > 0:
        after_warmup = float(iteration > opt.depth_from_iter)
        loss = loss + after_warmup * opt.lambda_isotropic * isotropic(params["scaling"], alive)
    loss = loss + depth_loss
    if stage_hook is not None:
        stage_hook("forward")

    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys] + [deltas])
    param_grads, delta_grads = dict(zip(keys, grads[:-1])), grads[-1]
    if stage_hook is not None:
        stage_hook("backward")

    # densification statistics (only while densification is active)
    if iteration < opt.densify_until_iter:
        state = accumulate_stats(state, delta_grads, out.radii)

    # Adam step, skipped on the final iteration as in the reference. Dead
    # (and frozen) rows get a torch.where SELECT of 0, never a multiply:
    # their cotangents can be NaN (0 x inf through guarded divisions), and
    # NaN * 0 is NaN; selecting 0 is exact and keeps dead slots finite.
    if iteration < opt.iterations:
        keep_row = alive & (torch.arange(cap, device=dev) >= freeze_rows)
        param_grads = {
            k: torch.where(keep_row.reshape((cap,) + (1,) * (g.ndim - 1)), g, 0.0)
            for k, g in param_grads.items()
        }
        new_params, adam = adam_update(state.params, param_grads, adam,
                                       compute_lrs(opt, iteration), frozen=frozen)
        state = state._replace(params=new_params)

    with torch.no_grad():
        mse = ((image.clamp(0.0, 1.0) - gt_image.clamp(0.0, 1.0)) ** 2).mean()
        metrics = StepMetrics(
            loss=loss.detach(),
            l1=ll1.detach(),
            depth_loss=depth_loss.detach(),
            psnr=-10.0 * torch.log10(torch.clamp_min(mse, 1e-12)),
            num_dropped_keys=out.num_dropped_keys,
            num_dropped_tail=out.num_dropped_tail,
            num_alive=alive.sum(),
        )
    return state, adam, metrics
