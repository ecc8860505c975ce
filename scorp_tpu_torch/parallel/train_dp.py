"""Camera-batch data-parallel training steps, port of
`scorp_tpu.parallel.train_dp`.

A replicated Gaussian state and a batch of B cameras (with their ground
truths) split over the ranks of a `Group`. Each rank renders and
differentiates its own cameras through `rasterize` (K1, K2, K3) or
`rasterize_surfel` (K1, K5, K6); the only communication is one SUM
all-reduce of the parameter gradients and densification sums and one MAX
all-reduce of the screen radii. Every rank then takes the same Adam step on
the gradient of the batch-mean loss: the B-camera generalisation of the
reference's one-camera iteration, with the full train_3dgs (or train_2dgs)
loss recipe and the reference's per-camera densification accounting, as B
sequential reference iterations would count it.

Semantics are the JAX `dp_train_step`'s, not `train_step`'s: Adam gets the
gradients unmasked and no frozen group, and runs on every iteration. The
isotropic term belongs to the state, not to a camera, so rank 0 adds it
once per step (in 2DGS only with an estimated depth, the reference's
nesting). Each camera is differentiated on its own (`loss_b / B`, one
backward each) and its gradients added up, so only one autograd graph is
alive at a time: the same sum as one backward of the mean loss, in another
f32 order. Each camera has its own zero `screen_deltas`, so its NDC
screen-gradient norm is its own (B x the gradient of the mean, as JAX
recovers it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..ops.losses import l1_loss, ssim
from ..ops.raster import RasterConfig, rasterize, rasterize_surfel
from ..ops.raster.surfel import depth_to_normal, surfel_maps
from ..train.state import AdamState, GaussianState, adam_update, expon_lr
from ..train.step import (OptParams, _masked_mean, _masked_minmax_normalize, compute_lrs,
                          isotropic)
from .mesh import Group

CAMERA_KEYS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")


def stack_cameras(cams: list[Camera]) -> dict:
    """Stack device cameras into a batch dict (all must share resolution)."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("stack_cameras needs one resolution for the whole batch")
    return {k: torch.stack([getattr(c, k) for c in cams]) for k in CAMERA_KEYS}


def batch_camera(cam_batch: dict, i: int, width: int, height: int) -> Camera:
    """Camera `i` of a stacked batch."""
    return Camera(**{k: cam_batch[k][i] for k in CAMERA_KEYS}, width=width, height=height)


def _depth_terms(rend_depth, d_cam, d_est, iteration, opt, has_depth_cam, has_depth_est):
    """The sensor-depth and normalised mono-depth L1 terms of one camera."""
    depth_loss = torch.zeros((), device=rend_depth.device)
    if has_depth_cam:
        m = (d_cam > 0.3) & (d_cam < 7.0) & (rend_depth > 0.0)
        depth_loss = depth_loss + opt.lambda_depth_sensor * _masked_mean(
            (rend_depth - d_cam).abs(), m)
    if has_depth_est:
        w = expon_lr(float(iteration), opt.dn_l1_weight_init, opt.dn_l1_weight_final,
                     opt.iterations)
        m = (rend_depth > 0.0) & (d_est > 0.0)
        pn = _masked_minmax_normalize(d_est, m)
        rn = _masked_minmax_normalize(rend_depth, m)
        depth_loss = depth_loss + 10.0 * w * _masked_mean((rn - pn).abs(), m)
    return depth_loss


def _loss_3d(params, deltas, alive, cam, gt, d_cam, d_est, iteration, bg, *, opt,
             sh_degree, cfg, has_depth_cam, has_depth_est):
    out = rasterize(
        params["xyz"], torch.sigmoid(params["opacity"][:, 0]), cam, bg,
        shs=torch.cat([params["f_dc"], params["f_rest"]], dim=1), sh_degree=sh_degree,
        scales=torch.exp(params["scaling"]), quats=params["rotation"],
        screen_deltas=deltas, alive=alive, cfg=cfg,
    )
    image = out.color
    ll1 = l1_loss(image, gt)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim(image, gt))
    if iteration > opt.depth_from_iter:
        one = torch.ones((), device=image.device)
        rend_depth = out.depth_accum / torch.where(out.alpha == 0.0, one, out.alpha)
        rend_depth = torch.nan_to_num(rend_depth, nan=0.0, posinf=0.0, neginf=0.0)
        loss = loss + _depth_terms(rend_depth, d_cam, d_est, iteration, opt,
                                   has_depth_cam, has_depth_est)
    return loss, ll1, out.radii


def _loss_2d(params, deltas, alive, cam, gt, d_cam, d_est, iteration, bg, *, opt,
             sh_degree, cfg, has_depth_cam, has_depth_est):
    out = rasterize_surfel(
        params["xyz"], torch.sigmoid(params["opacity"][:, 0]), cam, bg,
        shs=torch.cat([params["f_dc"], params["f_rest"]], dim=1), sh_degree=sh_degree,
        scales=torch.exp(params["scaling"]), quats=params["rotation"],
        screen_deltas=deltas, alive=alive, cfg=cfg,
    )
    image = out.color
    rend_normal, rend_depth, surf_normal = surfel_maps(out, cam, opt.depth_ratio)
    ll1 = l1_loss(image, gt)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim(image, gt))
    if iteration > opt.depth_from_iter:
        depth_loss = _depth_terms(rend_depth, d_cam, d_est, iteration, opt,
                                  has_depth_cam, has_depth_est)
        if has_depth_est and iteration > opt.depth_from_iter + 1000:
            w = expon_lr(float(iteration), opt.dn_l1_weight_init, opt.dn_l1_weight_final,
                         opt.iterations)
            pred_normal = depth_to_normal(cam, d_est).detach()
            dn = (1.0 - (surf_normal * pred_normal).sum(dim=0)).mean()
            rn_loss = (1.0 - (rend_normal * pred_normal).sum(dim=0)).mean()
            depth_loss = depth_loss + w * (dn + rn_loss)
        loss = loss + depth_loss
    if iteration > 7000 and opt.lambda_normal != 0.0:
        loss = loss + opt.lambda_normal * (1.0 - (rend_normal * surf_normal).sum(dim=0)).mean()
    if iteration > 3000 and opt.lambda_dist != 0.0:
        loss = loss + opt.lambda_dist * out.distortion.mean()
    return loss, ll1, out.radii


def _dp_step(camera_loss, with_iso, state, adam, cam_batch, gt_images, iteration, bg,
             gt_depth_cam, gt_depth_est, *, opt, sh_degree, cfg, width, height,
             has_depth_cam, has_depth_est, group):
    alive = state.alive
    cap = state.capacity
    dev = alive.device
    n_local = gt_images.shape[0]
    world = 1 if group is None else group.world_size
    rank = 0 if group is None else group.rank
    b = n_local * world  # the whole batch: the mean runs over every rank's cameras
    if gt_depth_cam is None:
        gt_depth_cam = torch.zeros_like(gt_images[:, :1])
    if gt_depth_est is None:
        gt_depth_est = torch.zeros_like(gt_images[:, :1])

    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    keys = list(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    sums = torch.zeros(2, cap + 1, device=dev)  # [grad-norm sum, visible count] + losses
    radii_max = torch.zeros(cap, device=dev)
    after_warmup = float(iteration > opt.depth_from_iter)
    for i in range(n_local):
        deltas = torch.zeros(cap, 2, device=dev, requires_grad=True)
        loss, ll1, radii = camera_loss(
            params, deltas, alive, batch_camera(cam_batch, i, width, height), gt_images[i],
            gt_depth_cam[i], gt_depth_est[i], iteration, bg, opt=opt, sh_degree=sh_degree,
            cfg=cfg, has_depth_cam=has_depth_cam, has_depth_est=has_depth_est)
        loss = loss / b
        if i == 0 and rank == 0 and with_iso and opt.lambda_isotropic > 0:
            # weighted, not skipped, before the warm-up ends (see train/step.py)
            loss = loss + after_warmup * opt.lambda_isotropic * isotropic(params["scaling"], alive)
        g = torch.autograd.grad(loss, [params[k] for k in keys] + [deltas])
        for k, gk in zip(keys, g[:-1]):
            grads[k] += gk
        visible = radii > 0
        gnorm = torch.sqrt((g[-1] * g[-1]).sum(-1)) * b
        with torch.no_grad():
            sums[0, :cap] += torch.where(visible, gnorm, 0.0)
            sums[1, :cap] += visible.to(torch.float32)
            sums[0, cap] += loss.detach()
            sums[1, cap] += ll1.detach() / b
            radii_max = torch.maximum(radii_max, radii.to(torch.float32))

    if group is not None:
        flat = torch.cat([grads[k].reshape(-1) for k in keys] + [sums.reshape(-1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        dist.all_reduce(radii_max, op=dist.ReduceOp.MAX)
        off = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = flat[off:off + n].view_as(grads[k])
            off += n
        sums = flat[off:].view_as(sums)

    if iteration < opt.densify_until_iter:
        state = state._replace(
            max_radii2d=torch.where(sums[1, :cap] > 0,
                                    torch.maximum(state.max_radii2d, radii_max),
                                    state.max_radii2d),
            xyz_grad_accum=state.xyz_grad_accum + sums[0, :cap],
            denom=state.denom + sums[1, :cap],
        )
    new_params, adam = adam_update(state.params, grads, adam, compute_lrs(opt, iteration))
    state = state._replace(params=new_params)
    return state, adam, {"loss": sums[0, cap], "l1": sums[1, cap]}


def dp_train_step(
    state: GaussianState,
    adam: AdamState,
    cam_batch: dict,              # this rank's stacked cameras, leading dim B / world
    gt_images: torch.Tensor,      # [B / world, 3, H, W]
    iteration: int,
    bg: torch.Tensor,             # [3]
    gt_depth_cam: torch.Tensor | None = None,  # [B / world, 1, H, W]
    gt_depth_est: torch.Tensor | None = None,  # [B / world, 1, H, W]
    *,
    opt: OptParams,
    sh_degree: int,
    cfg: RasterConfig,
    width: int,
    height: int,
    has_depth_cam: bool = False,
    has_depth_est: bool = False,
    group: Group | None = None,
):
    """One 3DGS step on the mean loss of the whole camera batch ->
    (state, adam, {"loss", "l1"}), identical on every rank. With a group,
    each rank passes its `shard_batch` of the cameras and ground truths and
    the replicated state. The inputs are not modified."""
    return _dp_step(_loss_3d, True, state, adam, cam_batch, gt_images, iteration, bg,
                    gt_depth_cam, gt_depth_est, opt=opt, sh_degree=sh_degree, cfg=cfg,
                    width=width, height=height, has_depth_cam=has_depth_cam,
                    has_depth_est=has_depth_est, group=group)


def dp_train_step_2d(
    state: GaussianState,
    adam: AdamState,
    cam_batch: dict,
    gt_images: torch.Tensor,
    iteration: int,
    bg: torch.Tensor,
    gt_depth_cam: torch.Tensor | None = None,
    gt_depth_est: torch.Tensor | None = None,
    *,
    opt,                          # Opt2DParams
    sh_degree: int,
    cfg: RasterConfig,
    width: int,
    height: int,
    has_depth_cam: bool = False,
    has_depth_est: bool = False,
    group: Group | None = None,
):
    """The camera-batch step of the 2DGS surfel trainer: dp_train_step's
    scaffolding with the train_2dgs loss recipe (photometric, normal
    consistency after 7k, distortion after 3k, depth and depth-normal
    terms; see train.step2d)."""
    return _dp_step(_loss_2d, has_depth_est, state, adam, cam_batch, gt_images, iteration,
                    bg, gt_depth_cam, gt_depth_est, opt=opt, sh_degree=sh_degree, cfg=cfg,
                    width=width, height=height, has_depth_cam=has_depth_cam,
                    has_depth_est=has_depth_est, group=group)
