"""Kernel K3 (csrc/backward.cu, composite_backward_kernel) in training:
the work model's least seconds of the traced iterations' backward
compositing over the kernel's CUPTI seconds, in percent."""
from bench_port.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", "3dgs", "composite_bwd", "composite_backward_kernel")
