"""Renderer layer (ops/raster/common.py depth_order): the device's busy ms
a viewer frame inside the program's `raster.route.depth_order` span (the
stable depth argsort of every row)."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "raster.route.depth_order")
