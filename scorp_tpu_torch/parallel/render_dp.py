"""Camera-parallel evaluation rendering, port of
`scorp_tpu.parallel.render_dp`.

Per-camera renders are independent (the reference's eval loop renders one
camera at a time), so the scale-out is embarrassingly parallel: each rank
renders its shard of the camera batch from the replicated Gaussians (K1 and
K2 per camera, the same calls `render()` makes, so the frames are
`render()`'s bit for bit), and with a group the frames are gathered to
every rank in batch order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.raster import RasterConfig, expected_depth, rasterize
from ..train.state import raster_inputs
from .mesh import Group
from .train_dp import batch_camera


def dp_render(
    params: dict,                 # GaussianState.params (replicated)
    alive: torch.Tensor,          # [cap] bool (replicated)
    cam_batch: dict,              # this rank's stacked cameras, leading dim B / world
    bg: torch.Tensor,             # [3]
    *,
    sh_degree: int,
    cfg: RasterConfig,
    width: int,
    height: int,
    group: Group | None = None,
):
    """Render a batch of cameras -> (color [B,3,H,W], alpha [B,1,H,W],
    depth [B,1,H,W]), depth being depth_accum / alpha with nan_to_num. With
    a group, each rank passes its `shard_batch` of the cameras and gets the
    whole batch's frames back."""
    frames = []
    with torch.no_grad():
        inputs = raster_inputs(params, alive)
        for i in range(cam_batch["viewmatrix"].shape[0]):
            out = rasterize(cam=batch_camera(cam_batch, i, width, height), bg=bg,
                            sh_degree=sh_degree, cfg=cfg, **inputs)
            frames.append(torch.cat([out.color, out.alpha,
                                     expected_depth(out.depth_accum, out.alpha)]))
    local = torch.stack(frames)                    # [B / world, 5, H, W]
    if group is not None:
        parts = [torch.empty_like(local) for _ in range(group.world_size)]
        dist.all_gather(parts, local)
        local = torch.cat(parts)
    return local[:, :3], local[:, 3:4], local[:, 4:5]
