"""The reference's copy of a training cell's first steps: from the state
the benchmark made, the same views, backgrounds and decoded images, it
takes the recipe's loss, its gradients through the plain rasterizer, and
Adam's update, step after step. It reads nothing the program made."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from . import camera, loss, raster2d, raster3d


def decode(path: str, device) -> torch.Tensor:
    """[3, H, W] float32 in [0, 1] of an image file."""
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return torch.as_tensor(arr, device=device).permute(2, 0, 1).contiguous()


def loss_and_grads(params: dict, alive: torch.Tensor, cam: dict, gt: torch.Tensor,
                   bg: torch.Tensor, iteration: int, opt: dict, primitive: str,
                   dtype=torch.float32):
    """(loss, {group: gradient}) of one step of the recipe: L1 + SSIM, the
    isotropic term after its warm-up (3DGS; 2DGS adds it only with an
    estimated depth, which the capture has not), and for 2DGS the normal
    consistency of the rendered normal with the median depth's after
    iteration 7,000 (distortion weighs 0)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with raster3d.tf32_off():
        if primitive == "3dgs":
            proj = raster3d.project(leaves, alive, cam)
            bins = raster3d.bin_tiles(proj.table[:, 8].detach(), proj.rect, proj.valid,
                                      cam["width"], cam["height"])
            frame = raster3d.forward(proj.table, bins, bg, cam["width"], cam["height"], dtype)
            image = frame.color.detach().requires_grad_(True)
            photo = loss.photometric(image, gt, opt["lambda_dssim"])
            after_warmup = float(iteration > opt["depth_from_iter"])
            extra = after_warmup * opt["lambda_isotropic"] * loss.isotropic(leaves["scaling"], alive)
            g_image, = torch.autograd.grad(photo, image)
            d_table = raster3d.backward_tiles(proj.table, bins, bg, g_image, dtype)
        else:
            proj = raster2d.project(leaves, alive, cam)
            bins = raster3d.bin_tiles(proj.depth.detach(), proj.rect, proj.valid,
                                      cam["width"], cam["height"])
            frame = raster2d.forward(proj.table, bins, bg, cam["width"], cam["height"], dtype)
            image = frame.color.detach().requires_grad_(True)
            normal = frame.normal.detach().requires_grad_(True)
            median = frame.median.detach().requires_grad_(True)
            photo = loss.photometric(image, gt, opt["lambda_dssim"])
            if iteration > 7000 and opt["lambda_normal"] != 0.0:
                world = (normal.permute(1, 2, 0)[..., :, None] * cam["view"][:3, :3]).sum(-2)
                surf = raster2d.depth_to_normal(cam, median) * frame.alpha
                photo = photo + opt["lambda_normal"] * (
                    1.0 - (world.permute(2, 0, 1) * surf).sum(0)).mean()
            extra = torch.zeros((), device=gt.device, requires_grad=True)
            g_image, g_normal, g_median = (
                torch.zeros_like(t) if g is None else g
                for t, g in zip((image, normal, median), torch.autograd.grad(
                    photo, [image, normal, median], allow_unused=True)))
            d_table = raster2d.backward_tiles(proj.table, bins, bg, g_image, g_normal, g_median,
                                              dtype)
        total = photo + extra
        keys = list(leaves)
        grads = torch.autograd.grad([proj.table, extra], [leaves[k] for k in keys],
                                    [d_table, torch.ones_like(extra)], allow_unused=True)
    out = {}
    for k, g in zip(keys, grads):
        g = torch.zeros_like(leaves[k]) if g is None else g
        out[k] = torch.where(alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
    return float(total.detach()), out


def follow(start: dict, steps: list[dict], cfg: dict, device, dtype=torch.float32) -> dict:
    """The readings of the reference's steps from `start` (params, v, alive,
    step): each step's loss, each group's gradient at the first step and
    change after the last (per row, and as float64 norms), and for surfels
    each row's |cos| of ray and normal in the first step's view and the
    least over the steps' views (raster2d.facing_cos)."""
    params = {k: v.clone() for k, v in start["params"].items()}
    p0 = start["params"]
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: x.clone() for k, x in start["v"].items()}
    alive = start["alive"]
    opt = cfg["optimization"]
    losses, grad_norms, grad_rows, cos_first, cos_least = [], {}, {}, None, None
    for i, s in enumerate(steps):
        cam = camera.camera(s["pose"], cfg["width"], cfg["height"], device)
        gt = decode(s["image_path"], device)
        bg = torch.as_tensor(np.asarray(s["bg"], np.float32), device=device)
        value, grads = loss_and_grads(params, alive, cam, gt, bg, s["iteration"], opt,
                                      cfg["primitive"], dtype)
        losses.append(value)
        if cfg["primitive"] == "2dgs":
            cos = raster2d.facing_cos(params, cam)
            cos_first = cos if i == 0 else cos_first
            cos_least = cos if cos_least is None else torch.minimum(cos_least, cos)
        if i == 0:
            grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
            grad_rows = grads
        params, m, v = loss.adam(params, grads, m, v, start["step"] + i + 1,
                                 loss.learning_rates(opt, s["iteration"]))
    change_rows = {k: params[k] - p0[k] for k in params}
    change = {k: float(d.double().norm()) for k, d in change_rows.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "grad_rows": grad_rows, "change_rows": change_rows, "cos_first": cos_first,
            "cos_least": cos_least}
