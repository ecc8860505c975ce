"""Renderer layer (ops/raster preprocess): the device's busy ms a viewer
frame inside the program's `raster.preprocess` span (projection, EWA
covariance, SH colour and cull of every row)."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "raster.preprocess")
