"""Renderer layer (ops/raster/common.py bin_stream): the device's busy ms
a viewer frame inside the program's `raster.gather` span (the stream
table and its rows gathered by the stream's gid)."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "raster.gather")
