"""Kernel K6 (csrc/surfel_backward.cu, surfel_backward_kernel) in 2DGS
training: the work model's least seconds of the traced iterations' surfel
backward compositing over the kernel's CUPTI seconds, in percent."""
from bench_port.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", "2dgs", "surfel_composite_bwd", "surfel_backward_kernel")
