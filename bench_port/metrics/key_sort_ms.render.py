"""Kernels layer (csrc/sort.cu): the device's busy ms a viewer frame
inside the program's `raster.route.sort` span (the keys-only radix sort
of K1's packed keys)."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "raster.route.sort")
