"""Kernel T (csrc/tsdf_fuse.cu, tsdf_fuse_kernel) in the fusion loop's views:
the work model's least seconds of the traced views' updates
(bench_port/work/tsdf_fuse.py) over the kernel's CUPTI seconds, in
percent."""

from bench_port.metrics._kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "fuse2d", "2dgs", "tsdf_fuse", "tsdf_fuse_kernel")
