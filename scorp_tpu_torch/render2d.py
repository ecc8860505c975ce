"""High-level 2DGS render entry point (the reference renderer's contract),
port of `scorp_tpu.render2d`.

The output dictionary of the original 2DGS `gaussian_renderer.render`:
rendered image, radii/visibility, alpha, world-space normal map,
expected/median depth mixed by `depth_ratio` into `render_depth`, the
distortion map, and the depth-derived pseudo surface normal scaled by the
detached alpha. Consumes either a padded `GaussianState` (scaling [N, 2])
or host-side `GaussianData`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.plyio import GaussianData
from .ops.raster import RasterConfig, rasterize_surfel
from .ops.raster.surfel import surfel_maps
from .render import default_raster_config
from .train.state import GaussianState, from_gaussian_data, raster_inputs
from .utils.trace import span


def render2d(
    cam: Camera,
    gaussians: GaussianState | GaussianData,
    bg: torch.Tensor | np.ndarray,
    *,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    sh_degree: int | None = None,
    depth_ratio: float = 1.0,
    cfg: RasterConfig | None = None,
):
    """Render surfels on the camera's device. GaussianData is uploaded there."""
    dev = cam.device
    with span("render"):
        if isinstance(gaussians, GaussianData):
            gaussians = from_gaussian_data(gaussians, device=dev)
        if cfg is None:
            cfg = default_raster_config(gaussians.capacity)
        degree = gaussians.sh_degree if sh_degree is None else sh_degree
        out = rasterize_surfel(
            cam=cam, bg=torch.as_tensor(bg, dtype=torch.float32, device=dev),
            sh_degree=degree, scale_modifier=scaling_modifier, cfg=cfg,
            **raster_inputs(gaussians.params, gaussians.alive, override_color),
        )
        with span("render.surfel_maps"):
            render_normal, surf_depth, surf_normal = surfel_maps(out, cam, depth_ratio)
        return {
            "render": out.color,
            "radii": out.radii,
            "visibility_filter": out.radii > 0,
            "render_alpha": out.alpha,
            "render_normal": render_normal,
            "render_dist": out.distortion,
            "render_depth": surf_depth,
            "surf_normal": surf_normal,
            "num_dropped_keys": out.num_dropped_keys,
        }
