"""Tile-based Gaussian rasterizers, differentiable: `rasterize` (3DGS) and
`rasterize_surfel` (2DGS surfels). They dispatch on the tensors' device:
the kernel wrappers launch the CUDA kernels for CUDA tensors and run their
plain PyTorch versions for CPU tensors. A call is the grad path when grad
is enabled and an input requires it, else the eval path. Both rasterizers
run one sequence:

1. preprocess and the per-primitive table. 3DGS: the fused kernel
   (`preprocess_kernel`) on the eval path, its plain version
   (`preprocess_plain`), which autograd records, on the grad path; the
   [N, 10] table (`stream_table`). Surfels: `preprocess_surfel` and the
   [N, 21] table (`surfel_table`), which autograd records on the grad path;
2. the routing (`route_stream`: key expansion K1 + a keys-only radix sort
   of its packed int32 keys, int64 past 2^31, `sort.py`) under no_grad;
   surfels cull by their two ellipses (`surfel_cull_ellipses`);
3. on the grad path, a `torch.autograd.Function` (`_Composite`,
   `_SurfelComposite`) that gathers the table's rows by `gid` and runs the
   training compositor (K2 with n_contrib and t_final; K5); its backward
   (K3; K6) adds each stream row's gradient onto its table row, and
   d_bg = Σ T_final·g_color. Autograd carries the table's gradient back
   through conic_chol, log2_opacity and preprocess (through `surfel_adj`'s
   cross products to M for surfels). On the eval path, the gather of the
   table's rows by `gid` and the eval compositor (K2; K4), with nothing
   saved and no n_contrib tracked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.camera import Camera
from ...utils.trace import span
from .backward import composite_backward
from .common import (  # noqa: F401
    TILE,
    Preprocessed,
    RasterConfig,
    StreamRouting,
    expected_depth,
    grid_dims,
    preprocess_plain,
    route_stream,
    stream_table,
    tiles_cp_to_image,
)
from .composite import composite
from .fused_preprocess import preprocess_kernel
from .surfel import (  # noqa: F401
    SurfelOutput,
    SurfelPrep,
    preprocess_surfel,
    surfel_cull_ellipses,
    surfel_table,
)
from .surfel_backward import surfel_backward
from .surfel_composite import surfel_composite, surfel_composite_train


class RasterOutput(NamedTuple):
    color: torch.Tensor        # [3, H, W]
    depth_accum: torch.Tensor  # [1, H, W] alpha-weighted accumulated view z
    alpha: torch.Tensor        # [1, H, W]
    radii: torch.Tensor        # [N] int32
    num_dropped_keys: torch.Tensor  # [] keys that did not fit the capacities


def _needs_grad(cam: Camera, tensors) -> bool:
    """Raise unless every given tensor lies on the camera's device; True when
    the call is the grad path: grad is enabled and an input requires it."""
    dev = cam.device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, but the camera is on {dev}")
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _Composite(torch.autograd.Function):
    """(table [N,10], routing, bg) -> tile images (color, depth, alpha)."""

    @staticmethod
    def forward(ctx, table, gid, tile_start, tile_count, bg, tiles_x):
        with span("raster.gather"):
            data = table[gid].contiguous()
        with span("raster.composite"):
            color, depth, alpha, n_contrib, t_final = composite(
                data, tile_start, tile_count, bg, tiles_x=tiles_x,
                track_ncontrib=True, with_t_final=True,
            )
        ctx.save_for_backward(data, gid, tile_start, tile_count, bg, t_final, n_contrib)
        ctx.n_rows, ctx.tiles_x = table.shape[0], tiles_x
        return color, depth, alpha

    @staticmethod
    def backward(ctx, g_color, g_depth, g_alpha):
        data, gid, tile_start, tile_count, bg, t_final, n_contrib = ctx.saved_tensors
        with span("raster.backward"):
            # unused outputs arrive as zeros (autograd materializes them)
            g_color, g_depth, g_alpha = (g.contiguous() for g in (g_color, g_depth, g_alpha))
            d_table = d_bg = None
            if ctx.needs_input_grad[0]:
                d_table = composite_backward(
                    data, gid, tile_start, tile_count, bg, g_color, g_depth, g_alpha,
                    t_final, n_contrib, ctx.n_rows, tiles_x=ctx.tiles_x,
                )
            if ctx.needs_input_grad[4]:
                d_bg = (t_final * g_color).sum(dim=(0, 2))
        return d_table, None, None, None, d_bg, None


def rasterize(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    bg: torch.Tensor,
    *,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    quats: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_deltas: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    cfg: RasterConfig = RasterConfig(),
) -> RasterOutput:
    """Rasterize on the camera's device (the counterpart of `scorp_tpu`'s
    `rasterize_pallas`); every tensor must lie on that device. Without any
    input that requires grad this is the eval path: nothing is saved for a
    backward and no n_contrib is tracked."""
    needs_grad = _needs_grad(cam, [means3d, opacities, bg, shs, colors_precomp, scales, quats,
                                   cov3d_precomp, screen_deltas, alive])
    w, h = cam.width, cam.height
    tiles_x = grid_dims(w, h)[0]
    # the kernel has no backward: autograd records the plain version
    prep_fn = preprocess_plain if needs_grad else preprocess_kernel
    with torch.set_grad_enabled(needs_grad), span("raster.preprocess"):
        prep = prep_fn(
            means3d, opacities, cam,
            shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp,
            scales=scales, quats=quats, cov3d_precomp=cov3d_precomp,
            scale_modifier=scale_modifier, screen_deltas=screen_deltas, alive=alive,
        )
    bg = bg.to(torch.float32).contiguous()
    with torch.no_grad():
        route = route_stream(prep, w, h, cfg)
    if needs_grad:
        color_t, depth_t, alpha_t = _Composite.apply(
            stream_table(prep), route.gid, route.tile_start, route.tile_count, bg, tiles_x)
    else:
        with torch.no_grad():
            with span("raster.gather"):
                data = stream_table(prep)[route.gid].contiguous()
            with span("raster.composite"):
                color_t, depth_t, alpha_t, _ = composite(
                    data, route.tile_start, route.tile_count, bg, tiles_x=tiles_x)
    return RasterOutput(
        tiles_cp_to_image(color_t, w, h),
        tiles_cp_to_image(depth_t, w, h),
        tiles_cp_to_image(alpha_t, w, h),
        prep.radii,
        route.num_dropped_keys,
    )


class _SurfelComposite(torch.autograd.Function):
    """(table [N,21], routing, bg) -> the six surfel tile images (color,
    alpha, depth, normal, median, distortion)."""

    @staticmethod
    def forward(ctx, table, gid, tile_start, tile_count, bg, tiles_x):
        with span("raster.gather"):
            data = table[gid].contiguous()
        with span("raster.composite"):
            outs = surfel_composite_train(data, tile_start, tile_count, bg, tiles_x=tiles_x)
        ctx.save_for_backward(data, gid, tile_start, tile_count, bg, *outs[6:])
        ctx.n_rows, ctx.tiles_x = table.shape[0], tiles_x
        return outs[:6]

    @staticmethod
    def backward(ctx, g_color, g_alpha, g_depth, g_normal, g_median, g_dist):
        data, gid, tile_start, tile_count, bg, n_contrib, n_med, wm, wm2, t_final = (
            ctx.saved_tensors)
        with span("raster.backward"):
            # unused outputs arrive as zeros (autograd materializes them)
            grads = [g.contiguous() for g in (g_color, g_alpha, g_depth, g_normal, g_median,
                                              g_dist)]
            d_table = d_bg = None
            if ctx.needs_input_grad[0]:
                d_table = surfel_backward(
                    data, gid, tile_start, tile_count, bg, *grads, t_final, n_contrib, n_med,
                    wm, wm2, ctx.n_rows, tiles_x=ctx.tiles_x,
                )
            if ctx.needs_input_grad[4]:
                d_bg = (t_final * grads[0]).sum(dim=(0, 2))
        return d_table, None, None, None, d_bg, None


def rasterize_surfel(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    bg: torch.Tensor,
    *,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    colors_precomp: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    quats: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    screen_deltas: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    cfg: RasterConfig = RasterConfig(),
) -> SurfelOutput:
    """Rasterize 2DGS surfels on the camera's device (the counterpart of
    `scorp_tpu`'s `rasterize_surfel_pallas`; `scales` is [N, 2]); every
    tensor must lie on that device. Without any input that requires grad
    this is the eval path (K4, nothing saved for a backward)."""
    needs_grad = _needs_grad(cam, [means3d, opacities, bg, shs, colors_precomp, scales, quats,
                                   screen_deltas, alive])
    w, h = cam.width, cam.height
    tiles_x = grid_dims(w, h)[0]
    with torch.set_grad_enabled(needs_grad), span("raster.preprocess"):
        prep = preprocess_surfel(
            means3d, opacities, cam, shs=shs, sh_degree=sh_degree,
            colors_precomp=colors_precomp, scales=scales, quats=quats,
            scale_modifier=scale_modifier, screen_deltas=screen_deltas, alive=alive,
        )
        table = surfel_table(prep)
    bg = bg.to(torch.float32).contiguous()
    with torch.no_grad():
        with span("raster.surfel_cull"):
            ell, circ = surfel_cull_ellipses(prep)
        route = route_stream(prep, w, h, cfg, geo=ell, geo2=circ)
    if needs_grad:
        outs = _SurfelComposite.apply(table, route.gid, route.tile_start, route.tile_count,
                                      bg, tiles_x)
    else:
        with torch.no_grad():
            with span("raster.gather"):
                data = table[route.gid].contiguous()
            with span("raster.composite"):
                outs = surfel_composite(data, route.tile_start, route.tile_count, bg,
                                        tiles_x=tiles_x)
    return SurfelOutput(
        *(tiles_cp_to_image(o, w, h) for o in outs),
        prep.radii,
        route.num_dropped_keys,
    )
