"""The 2DGS (surfel) training step, port of `scorp_tpu.train.step2d`.

One call covers the hot loop of the reference 2DGS trainer: render surfels
-> photometric + depth losses as in the 3DGS step, plus the 2DGS
regularizers -> backward through the differentiable surfel rasterizer
(kernels K1, K5 and K6 on CUDA tensors) -> per-group Adam -> densification
statistics. The regularizers (train_2dgs.py:141-150 of the reference):
  * normal consistency λ_normal·mean(1 − rend_normal·surf_normal) after
    iteration 7000;
  * depth distortion λ_dist·mean(render_dist) after iteration 3000;
  * depth-normal terms after depth_from_iter + 1000 when an estimated depth
    exists: w·[(1 − surf_normal·pred_normal) + (1 − rend_normal·pred_normal)].
A term of the render whose weight is zero at this iteration is skipped, not
multiplied by zero: its gradient is zero either way. The isotropic term
reads the scaling itself and is multiplied by its zero warm-up weight, as in
the JAX step, so an overflowing scale makes the loss NaN in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.camera import Camera
from ..ops.losses import l1_loss, ssim
from ..ops.raster import RasterConfig, rasterize_surfel
from ..ops.raster.surfel import depth_to_normal, surfel_maps
from .densify import accumulate_stats
from .state import AdamState, GaussianState, adam_update, expon_lr
from .step import (OptParams, StepMetrics, _masked_mean, _masked_minmax_normalize, compute_lrs,
                   isotropic)


@dataclass(frozen=True)
class Opt2DParams(OptParams):
    """2DGS deltas (gs2dgs/arguments/__init__.py:95-109)."""

    lambda_normal: float = 0.05
    lambda_dist: float = 0.0
    depth_ratio: float = 1.0
    opacity_cull: float = 0.5
    max_screen_size: float = 0.2
    # gs2dgs overrides of the 3DGS loss weights
    lambda_isotropic: float = 0.0001
    dn_l1_weight_init: float = 0.2
    dn_l1_weight_final: float = 0.05


def train_step_2d(
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
    opt: Opt2DParams,
    sh_degree: int,
    cfg: RasterConfig,
    has_depth_cam: bool = False,
    has_depth_est: bool = False,
    frozen: tuple[str, ...] = (),
    stage_hook=None,
):
    """One step on the camera's device -> (state, adam, StepMetrics), as
    `train_step` (the inputs are not modified; `stage_hook` is called with
    "forward" once the loss is formed and with "backward" once the
    gradients are)."""
    alive = state.alive
    cap = state.capacity
    dev = alive.device
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    deltas = torch.zeros(cap, 2, device=dev, requires_grad=True)

    out = rasterize_surfel(
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
    rend_normal, rend_depth, surf_normal = surfel_maps(out, cam, opt.depth_ratio)
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim(image, gt_image))

    depth_loss = torch.zeros((), device=dev)
    if iteration > opt.depth_from_iter:
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
            if iteration > opt.depth_from_iter + 1000:
                # depth-normal consistency after an extra 1000-iteration warmup
                pred_normal = depth_to_normal(cam, gt_depth_est).detach()
                dn = (1.0 - (surf_normal * pred_normal).sum(dim=0)).mean()
                rn_loss = (1.0 - (rend_normal * pred_normal).sum(dim=0)).mean()
                depth_loss = depth_loss + w * (dn + rn_loss)
    # the reference adds the isotropic term only inside the depth_est
    # branch (train_2dgs.py loss nesting); weighted, not skipped (see step.py)
    if has_depth_est and opt.lambda_isotropic > 0:
        after_warmup = float(iteration > opt.depth_from_iter)
        loss = loss + after_warmup * opt.lambda_isotropic * isotropic(params["scaling"], alive)
    total = loss + depth_loss
    if iteration > 7000 and opt.lambda_normal != 0.0:
        total = total + opt.lambda_normal * (1.0 - (rend_normal * surf_normal).sum(dim=0)).mean()
    if iteration > 3000 and opt.lambda_dist != 0.0:
        total = total + opt.lambda_dist * out.distortion.mean()
    if stage_hook is not None:
        stage_hook("forward")

    keys = list(params)
    grads = torch.autograd.grad(total, [params[k] for k in keys] + [deltas])
    param_grads, delta_grads = dict(zip(keys, grads[:-1])), grads[-1]
    if stage_hook is not None:
        stage_hook("backward")

    if iteration < opt.densify_until_iter:
        state = accumulate_stats(state, delta_grads, out.radii)

    # Adam step, skipped on the final iteration; dead and frozen rows get a
    # torch.where SELECT of 0, never a multiply (see train_step)
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
            loss=total.detach(),
            l1=ll1.detach(),
            depth_loss=depth_loss.detach(),
            psnr=-10.0 * torch.log10(torch.clamp_min(mse, 1e-12)),
            num_dropped_keys=out.num_dropped_keys,
            num_dropped_tail=out.num_dropped_tail,
            num_alive=alive.sum(),
        )
    return state, adam, metrics
