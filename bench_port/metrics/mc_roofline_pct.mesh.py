"""Kernel M (csrc/marching_cubes.cu: mc_cells_count, mc_verts, mc_cells_emit)
in the export loop's triangulations: the work model's least seconds of the
traced triangulations (bench_port/work/marching_cubes.py) over the CUPTI
seconds of M's kernels, summed by function name, in percent."""

from bench_port.metrics._kernels import device_seconds

FUNCTIONS = ("mc_cells_count", "mc_verts", "mc_cells_emit")


def read(ctx):
    if ctx["loop"] != "extract2d" or "marching_cubes" not in ctx["least_s"]:
        return None
    t = sum(device_seconds(ctx, f) for f in FUNCTIONS)
    if t <= 0:
        return None
    return 100.0 * ctx["least_s"]["marching_cubes"] / t
