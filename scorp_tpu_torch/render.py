"""High-level render entry point (the reference renderer's contract), port
of `scorp_tpu.render`.

The output dictionary of the original 3DGS `gaussian_renderer.render`:
rendered image, visibility filter (radii > 0), radii, alpha-normalized depth
with nan_to_num, and accumulated alpha. Consumes either a padded
`GaussianState` or host-side `GaussianData`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.plyio import GaussianData
from .ops.raster import RasterConfig, expected_depth, rasterize
from .train.state import GaussianState, from_gaussian_data, raster_inputs
from .utils.trace import span

# expanded keys a gaussian is given room for in the key capacity
AVG_TILES_PER_GAUSSIAN = 16


def render(
    cam: Camera,
    gaussians: GaussianState | GaussianData,
    bg: torch.Tensor | np.ndarray,
    *,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    sh_degree: int | None = None,
    cfg: RasterConfig | None = None,
):
    """Render on the camera's device. GaussianData is uploaded there."""
    dev = cam.device
    with span("render"):
        if isinstance(gaussians, GaussianData):
            gaussians = from_gaussian_data(gaussians, device=dev)
        if cfg is None:
            cfg = default_raster_config(gaussians.capacity)
        degree = gaussians.sh_degree if sh_degree is None else sh_degree
        out = rasterize(
            cam=cam, bg=torch.as_tensor(bg, dtype=torch.float32, device=dev),
            sh_degree=degree, scale_modifier=scaling_modifier, cfg=cfg,
            **raster_inputs(gaussians.params, gaussians.alive, override_color),
        )
        return {
            "render": out.color,
            "render_depth": expected_depth(out.depth_accum, out.alpha),
            "render_alpha": out.alpha,
            "radii": out.radii,
            "visibility_filter": out.radii > 0,
            "num_dropped_keys": out.num_dropped_keys,
        }


def default_raster_config(capacity: int) -> RasterConfig:
    """Key capacity from the Gaussian capacity (power of two). Conservative:
    no post-cull stream trim, for call sites without overflow-regrow
    handling. The capacity is a ceiling: the key buffers follow each
    frame's expanded keys (`ops.raster.expand.key_slots`), so a large
    capacity costs nothing in a frame that does not fill it."""
    max_keys = 1 << max(14, (capacity * AVG_TILES_PER_GAUSSIAN - 1).bit_length())
    return RasterConfig(max_keys=max_keys)


def tuned_raster_config(
    capacity: int,
    *,
    max_keys: int | None = None,
    stream_keys: int | None = None,
) -> RasterConfig:
    """The configuration for training loops: a post-cull stream trim at 3/4
    of the expansion capacity (the exact ellipse-tile cull drops 15-50% of
    expanded keys). Overflow of either capacity is reported via
    num_dropped_keys; callers MUST handle it with regrow_config. Both
    capacities are ceilings: the key buffers follow each frame's expanded
    keys (`ops.raster.expand.key_slots`)."""
    if max_keys is None:
        max_keys = 1 << min(22, max(14, (capacity * AVG_TILES_PER_GAUSSIAN - 1).bit_length()))
    if stream_keys is None:
        stream_keys = max_keys // 4 * 3
    return RasterConfig(max_keys=max_keys, stream_keys=stream_keys)


def regrow_config(cfg: RasterConfig, dropped_keys: int) -> RasterConfig:
    """Double the key capacities after an overflow, keeping the stream-trim
    ratio."""
    if dropped_keys:
        cfg = cfg._replace(
            max_keys=cfg.max_keys * 2,
            stream_keys=cfg.stream_keys * 2 if cfg.stream_keys else 0,
        )
    return cfg
