"""Renderer layer (ops/raster/surfel.py surfel_cull_ellipses): the device's
busy ms a 2DGS viewer frame inside the program's `raster.surfel_cull` span
(K1's two screen ellipses per surfel: the UV-disc conic and the low-pass
circle)."""

from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "raster.surfel_cull")
