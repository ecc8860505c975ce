"""Mesh layer (pipeline/mesh.py TsdfVolume.triangulate): the host's waits
for the device a triangulation, the program's `sync.*` spans a frame of the
export loop (the read of kernel M's totals after its count pass, and the
wait for the mesh's copy to host memory)."""
from bench_port.metrics._syncs import per_unit


def read(ctx):
    w = per_unit(ctx, "extract2d")
    return None if w is None else w[0]
