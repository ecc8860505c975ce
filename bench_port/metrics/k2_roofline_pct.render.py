"""Kernel K2 (csrc/composite.cu, composite_kernel) in the viewer's frames:
the work model's least seconds of the traced frames' forward compositing
over the kernel's CUPTI seconds, in percent."""
from bench_port.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "render", "3dgs", "composite_fwd", "composite_kernel")
