"""Mesh layer (pipeline/mesh.py TsdfVolume.triangulate): the host's ms a
triangulation inside the program's `sync.*` spans, the time it is held
waiting for the device (see host_syncs.mesh for the sites)."""
from bench_port.metrics._syncs import per_unit


def read(ctx):
    w = per_unit(ctx, "extract2d")
    return None if w is None else 1e3 * w[1]
