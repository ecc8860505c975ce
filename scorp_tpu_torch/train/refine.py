"""Registration-constrained appearance refinement step, port of
`scorp_tpu.train.refine` (the core of the reference's `post_refine_gs.py`).

Colour-only optimization of the merged aligned proxies against masked
object RGBA ground truth, with xyz, rotation, scaling and opacity frozen:

    loss = (1-λ)·L1(image·α, gt·α) + λ·(1-SSIM(image·α, gt·α))

through the differentiable `rasterize` (K1, K2 forward; K3 backward on CUDA
tensors) and the per-group Adam (only the feature learning rates matter).
Like `train_step`, it asks for no host synchronisation.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera
from ..ops.losses import l1_loss, ssim
from ..ops.raster import RasterConfig, rasterize
from .state import AdamState, GaussianState, adam_update, raster_inputs
from .step import OptParams, compute_lrs

FROZEN_REFINE = ("xyz", "rotation", "scaling", "opacity")


def refine_step(
    state: GaussianState,
    adam: AdamState,
    cam: Camera,
    gt_image: torch.Tensor,   # [3, H, W]
    gt_alpha: torch.Tensor,   # [1, H, W]
    iteration: int,           # 1-based
    bg: torch.Tensor,         # [3]
    *,
    opt: OptParams,
    sh_degree: int,
    cfg: RasterConfig,
    frozen: tuple[str, ...] = FROZEN_REFINE,
):
    """One step on the camera's device -> (state, adam, {"loss", "l1"} as
    device scalars). The inputs are not modified; the Adam step is skipped
    when iteration >= opt.iterations, as in the JAX package."""
    alive = state.alive
    cap = state.capacity
    params = {k: v.detach().requires_grad_(k not in frozen) for k, v in state.params.items()}
    out = rasterize(cam=cam, bg=bg, sh_degree=sh_degree, cfg=cfg,
                    **raster_inputs(params, alive))
    mask = gt_alpha.expand_as(gt_image)
    masked_image = out.color * mask
    masked_gt = gt_image * mask
    ll1 = l1_loss(masked_image, masked_gt)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (
        1.0 - ssim(masked_image, masked_gt))

    keys = [k for k in params if k not in frozen]
    grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))
    if iteration < opt.iterations:
        # dead-row gradients SELECTED to exact 0 (NaN cotangents through
        # guarded divisions on padded rows; see train_step)
        grads = {k: torch.where(alive.reshape((cap,) + (1,) * (g.ndim - 1)), g, 0.0)
                 for k, g in grads.items()}
        new_params, adam = adam_update(state.params, grads, adam,
                                       compute_lrs(opt, iteration), frozen=frozen)
        state = state._replace(params=new_params)
    return state, adam, {"loss": loss.detach(), "l1": ll1.detach()}
