"""Renderer layer (ops/raster/common.py route_stream): the device's busy
ms a viewer frame inside the program's `raster.route` span (the depth
argsort, K1's inputs, K1, the key sort, the tile ranges, the stream's gid).
The depth argsort is the routing's first device work, before any kernel
that `raster.route` launches outside its children, so the span's own
footprint starts after it and its `raster.route.depth_order` child is
added."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    route = per_frame_ms(ctx, "raster.route")
    order = per_frame_ms(ctx, "raster.route.depth_order")
    return None if route is None else route + (order or 0.0)
