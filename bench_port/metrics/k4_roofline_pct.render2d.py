"""Kernel K4 (csrc/surfel_composite.cu, surfel_composite_kernel<false>) in
the 2DGS viewer's frames: the work model's least seconds of the traced
frames' surfel compositing over the kernel's CUPTI seconds, in percent."""

from bench_port.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "render", "2dgs", "surfel_composite_eval", "surfel_composite_kernel")
