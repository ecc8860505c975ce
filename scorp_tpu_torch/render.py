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
from .ops.raster import RasterConfig, rasterize
from .train.state import GaussianState, from_gaussian_data
from .utils.trace import span


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
        params = gaussians.params
        kwargs = dict(
            scales=torch.exp(params["scaling"]),
            quats=params["rotation"],
            scale_modifier=scaling_modifier,
            alive=gaussians.alive,
            cfg=cfg,
        )
        if override_color is not None:
            kwargs["colors_precomp"] = override_color
        else:
            kwargs["shs"] = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
            kwargs["sh_degree"] = degree
        out = rasterize(
            params["xyz"], torch.sigmoid(params["opacity"][:, 0]), cam,
            torch.as_tensor(bg, dtype=torch.float32, device=dev), **kwargs,
        )
        one = torch.ones((), device=dev)
        depth = out.depth_accum / torch.where(out.alpha == 0.0, one, out.alpha)
        depth = torch.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
        return {
            "render": out.color,
            "render_depth": depth,
            "render_alpha": out.alpha,
            "radii": out.radii,
            "visibility_filter": out.radii > 0,
            "num_dropped_keys": out.num_dropped_keys,
            "num_dropped_tail": out.num_dropped_tail,
        }


def default_raster_config(capacity: int, avg_tiles_per_gaussian: int = 16) -> RasterConfig:
    """Key capacity from the Gaussian capacity (power of two). Conservative:
    no post-cull stream trim, for call sites without overflow-regrow
    handling."""
    max_keys = 1 << max(14, (capacity * avg_tiles_per_gaussian - 1).bit_length())
    return RasterConfig(max_keys=max_keys)


def tuned_raster_config(
    capacity: int,
    *,
    avg_tiles_per_gaussian: int = 16,
    max_keys: int | None = None,
    stream_keys: int | None = None,
    bwd_block_frac: float = 0.66,
) -> RasterConfig:
    """The configuration for training loops: a post-cull stream trim at 3/4
    of the expansion capacity (the exact ellipse-tile cull drops 15-50% of
    expanded keys). Overflow of either capacity is reported via
    num_dropped_keys; callers MUST handle it with regrow_config.
    `bwd_block_frac` has no effect in this port (see RasterConfig)."""
    if max_keys is None:
        max_keys = 1 << min(22, max(14, (capacity * avg_tiles_per_gaussian - 1).bit_length()))
    if stream_keys is None:
        stream_keys = max_keys // 4 * 3
    return RasterConfig(max_keys=max_keys, stream_keys=stream_keys,
                        bwd_block_frac=bwd_block_frac)


def regrow_config(cfg: RasterConfig, dropped_keys: int) -> RasterConfig:
    """Double the key capacities after an overflow, keeping the stream-trim
    ratio."""
    if dropped_keys:
        cfg = cfg._replace(
            max_keys=cfg.max_keys * 2,
            stream_keys=cfg.stream_keys * 2 if cfg.stream_keys else 0,
        )
    return cfg
