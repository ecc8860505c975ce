"""3D mask lifting by gradient voting, port of `scorp_tpu.pipeline.mask3d`.

The reference renders with an all-ones override colour and, per prompt,
backpropagates the masked and inverse-masked render means, accumulating
±‖d(render)/d(color_i)‖ votes. The rasterizer is linear in the override
colours, so that gradient is exactly Σ_p w_ip·g_p (w = blending weights),
identical across channels, and

    ‖grad_masked‖ − ‖grad_inv‖ ∝ Σ_p w_ip·(2·mask_p − 1).

One render VJP per (camera, prompt) with the signed mask as cotangent gives
the same votes (same sign, positive scale). Here that VJP is the port's
differentiable `rasterize` on the state's device: key expansion (K1), the
forward compositor (K2) and the backward compositor (K3), whose d_table
carries the colour columns back to `colors_precomp`. A 2DGS state
(`surfel=True`, scaling [N, 2]) votes through `rasterize_surfel`: K1 with
its second ellipse, the surfel training compositor K5 and its reverse K6. The segmentation is
votes > 0. "binary" thresholds each camera's masked and inverse-masked
votes; "projection" votes by the projected centre's pixel.
"""

from __future__ import annotations

import math
import os
from typing import Literal

import numpy as np
import torch
from PIL import Image

from ..core.camera import Camera
from ..ops.raster import RasterConfig, preprocess_kernel, rasterize, rasterize_surfel
from ..render import default_raster_config
from ..train.state import GaussianState


def _gaussian_args(state: GaussianState) -> dict:
    p = state.params
    return dict(scales=torch.exp(p["scaling"]), quats=p["rotation"], alive=state.alive)


def vote_step(state: GaussianState, cam: Camera, signed_mask: torch.Tensor,
              bg: torch.Tensor, *, cfg: RasterConfig, surfel: bool = False) -> torch.Tensor:
    """One camera's signed gradient votes [N]: the gradient of the mean over
    H·W·3 of render·signed_mask with respect to all-ones override colours,
    column 0 times √3 (the reference's norm scaling)."""
    p = state.params
    raster_fn = rasterize_surfel if surfel else rasterize
    ones = torch.ones((state.capacity, 3), device=cam.device, requires_grad=True)
    with torch.enable_grad():
        out = raster_fn(p["xyz"], torch.sigmoid(p["opacity"][:, 0]), cam, bg,
                        colors_precomp=ones, cfg=cfg, **_gaussian_args(state))
        loss = (out.color * signed_mask[None, :, :]).mean()
        (grad,) = torch.autograd.grad(loss, ones)
    return grad[:, 0] * math.sqrt(3.0)


def projection_vote_step(state: GaussianState, cam: Camera, mask: torch.Tensor) -> torch.Tensor:
    """+1 / -1 for alive Gaussians whose projected centre (rounded half to
    even) falls inside / outside the mask, 0 off the image."""
    p = state.params
    ones = torch.ones((state.capacity, 3), device=cam.device)
    args = _gaussian_args(state)
    if args["scales"].shape[1] == 2:
        # a surfel state through the 3DGS preprocess, as in the JAX package,
        # whose out-of-range scale column reads the last one (only the
        # projected centres are used)
        args["scales"] = torch.cat([args["scales"], args["scales"][:, 1:]], dim=1)
    with torch.no_grad():
        prep = preprocess_kernel(p["xyz"], torch.sigmoid(p["opacity"][:, 0]), cam,
                                 colors_precomp=ones, **args)
        # f32 -> int32 as XLA converts: NaN to 0, saturating
        xy = torch.nan_to_num(torch.round(prep.xy), nan=0.0)
        xy = torch.clamp(xy, -2.0 ** 31, 2.0 ** 31 - 128).to(torch.int64)
        w, h = cam.width, cam.height
        inside = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        xc = torch.clamp(xy[:, 0], 0, w - 1)
        yc = torch.clamp(xy[:, 1], 0, h - 1)
        in_mask = mask[yc, xc] > 0
        one = torch.ones((), device=cam.device)
        return torch.where(inside & state.alive, torch.where(in_mask, one, -one), 0.0)


def load_mask_rgba(path: str, resolution=None) -> np.ndarray:
    """Read an object RGBA image; mask = alpha > 0."""
    with Image.open(path) as img:
        if resolution is not None and img.size != tuple(resolution):
            img = img.resize(resolution)
        arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 4:
        return arr[:, :, 3] > 0
    return arr.sum(axis=-1) > 0 if arr.ndim == 3 else arr > 0


def camera_votes(state: GaussianState, cam: Camera, mask: np.ndarray, bg: torch.Tensor,
                 voting_method: Literal["gradient", "binary", "projection"] = "gradient",
                 cfg: RasterConfig | None = None, surfel: bool = False) -> torch.Tensor:
    """One (camera, prompt) vote vector [N] by `voting_method`."""
    dev = cam.device
    if cfg is None:
        cfg = default_raster_config(state.capacity)
    if voting_method == "projection":
        return projection_vote_step(state, cam, torch.as_tensor(mask, device=dev))
    if voting_method == "binary":
        # the reference: +1 if any masked contribution, -1 if any inverse
        m = torch.as_tensor(mask.astype(np.float32), device=dev)
        v_in = vote_step(state, cam, m, bg, cfg=cfg, surfel=surfel)
        v_out = vote_step(state, cam, 1.0 - m, bg, cfg=cfg, surfel=surfel)
        return (v_in > 0).to(torch.float32) - (v_out > 0).to(torch.float32)
    signed = torch.as_tensor(np.where(mask, 1.0, -1.0).astype(np.float32), device=dev)
    return vote_step(state, cam, signed, bg, cfg=cfg, surfel=surfel)


def get_mask3d(
    state: GaussianState,
    cameras: list,
    prompts: list[str],
    data_dir: str,
    voting_method: Literal["gradient", "binary", "projection"] = "gradient",
    bg=None,
    cfg: RasterConfig | None = None,
    surfel: bool = False,
) -> np.ndarray:
    """Returns [num_prompts, N] boolean per-Gaussian masks (padded N). Runs
    on the state's device; the votes stay there until the end."""
    rgba_root = os.path.join(data_dir, "masked_image_rgba")
    if not os.path.exists(rgba_root):
        raise RuntimeError(f"`mask_with_image_rgba_dir` {rgba_root} does not exist")
    prompt_dirs = [os.path.join(rgba_root, p) for p in prompts]
    for d in prompt_dirs:
        if not os.path.exists(d):
            raise RuntimeError(f"prompt mask dir {d} does not exist")
    os.makedirs(os.path.join(rgba_root, "masked"), exist_ok=True)

    dev = state.alive.device
    if cfg is None:
        cfg = default_raster_config(state.capacity)
    bg = torch.as_tensor(np.zeros(3, np.float32) if bg is None else np.asarray(bg, np.float32),
                         device=dev)

    votes = torch.zeros((len(prompts), state.capacity), device=dev)
    for camera in cameras:
        cam = camera.to_torch(dev)
        for k, d in enumerate(prompt_dirs):
            mask = load_mask_rgba(os.path.join(d, f"{camera.image_name}.png"),
                                  camera.resolution)
            votes[k] += camera_votes(state, cam, mask, bg, voting_method, cfg, surfel)
    return (votes > 0).cpu().numpy()
