"""Renderer layer (ops/raster/surfel.py surfel_maps, from render2d.py): the
device's busy ms a 2DGS viewer frame inside the program's
`render.surfel_maps` span (the view normal rotated to world space, the
depth mix and the depth map's pseudo surface normal, `depth_to_normal`)."""

from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "render.surfel_maps")
