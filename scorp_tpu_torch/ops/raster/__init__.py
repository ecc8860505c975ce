"""Tile-based Gaussian rasterizer, differentiable.

`rasterize` runs preprocess -> key expansion (K1) + a keys-only radix sort
of its packed int32 keys (int64 past 2^31, `sort.py`) -> stream gather ->
forward compositor (K2). It dispatches on the tensors' device:
the kernel wrappers launch the CUDA kernels for CUDA tensors and run their
plain PyTorch versions for CPU tensors.

When an input requires grad, preprocess is recorded by autograd, the
routing runs under no_grad on the detached result, and `_Composite` (a
`torch.autograd.Function`) takes the per-gaussian table [N, 10]: its
forward gathers the stream rows and runs K2 with n_contrib and t_final,
its backward runs K3, which adds each stream row's gradient onto its
gaussian's table row, and d_bg = Σ T_final·g_color. Autograd then carries
the table's gradient back through conic_chol, log2_opacity and preprocess.

`rasterize_surfel` is the 2DGS surfel rasterizer, built the same way:
`preprocess_surfel` under autograd; the routing under no_grad, with K1
culling by the surfel's two ellipses (`surfel_cull_ellipses`);
`_SurfelComposite` takes the per-surfel table [N, 21] (`surfel_table`),
gathers its rows by `gid` and runs K5 forward and K6 + d_bg backward, so
autograd carries d_adj back to M through `surfel_adj`'s cross products.
Without an input that requires grad it runs the eval compositor K4 and
saves nothing.
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
    StreamBins,
    StreamRouting,
    bin_stream,
    grid_dims,
    preprocess,
    route_stream,
    stream_table,
    tiles_cp_to_image,
)
from .composite import composite
from .surfel import (  # noqa: F401
    SurfelOutput,
    SurfelPrep,
    preprocess_surfel,
    surfel_cull_ellipses,
    surfel_prep_to_common,
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
    num_dropped_tail: torch.Tensor  # [] always 0: there are no per-tile lists


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
    tensors = [means3d, opacities, bg, shs, colors_precomp, scales, quats,
               cov3d_precomp, screen_deltas, alive]
    dev = cam.device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, but the camera is on {dev}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)

    w, h = cam.width, cam.height
    tiles_x = grid_dims(w, h)[0]
    with torch.set_grad_enabled(needs_grad), span("raster.preprocess"):
        prep = preprocess(
            means3d, opacities, cam,
            shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp,
            scales=scales, quats=quats, cov3d_precomp=cov3d_precomp,
            scale_modifier=scale_modifier, screen_deltas=screen_deltas, alive=alive,
        )
    bg = bg.to(torch.float32).contiguous()
    if needs_grad:
        with torch.no_grad():
            route = route_stream(prep, w, h, cfg)
        color_t, depth_t, alpha_t = _Composite.apply(
            stream_table(prep), route.gid, route.tile_start, route.tile_count, bg, tiles_x)
        dropped = route.num_dropped_keys
    else:
        with torch.no_grad():
            bins = bin_stream(prep, w, h, cfg)
            with span("raster.composite"):
                color_t, depth_t, alpha_t, _ = composite(
                    bins.data, bins.tile_start, bins.tile_count, bg, tiles_x=tiles_x)
        dropped = bins.num_dropped_keys
    return RasterOutput(
        tiles_cp_to_image(color_t, w, h),
        tiles_cp_to_image(depth_t, w, h),
        tiles_cp_to_image(alpha_t, w, h),
        prep.radii,
        dropped,
        torch.zeros((), dtype=torch.int64, device=dev),
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
    tensors = [means3d, opacities, bg, shs, colors_precomp, scales, quats, screen_deltas,
               alive]
    dev = cam.device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, but the camera is on {dev}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)

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
        ell, circ = surfel_cull_ellipses(prep)
        route = route_stream(surfel_prep_to_common(prep), w, h, cfg, geo=ell, geo2=circ)
    if needs_grad:
        outs = _SurfelComposite.apply(table, route.gid, route.tile_start, route.tile_count,
                                      bg, tiles_x)
    else:
        with span("raster.gather"):
            data = table[route.gid].contiguous()
        with span("raster.composite"):
            outs = surfel_composite(data, route.tile_start, route.tile_count, bg,
                                    tiles_x=tiles_x)
    return SurfelOutput(
        *(tiles_cp_to_image(o, w, h) for o in outs),
        prep.radii,
        route.num_dropped_keys,
        torch.zeros((), dtype=torch.int64, device=dev),
    )
