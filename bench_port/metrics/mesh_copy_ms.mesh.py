"""Mesh layer (pipeline/mesh.py TsdfVolume.triangulate): the device's busy ms
a triangulation inside the program's `mesh.to_host` span (the copy of the
mesh's vertices, faces and colours to host memory), over the triangulations
of a traced run of the export loop (the count of its `unit.extract` label)."""


def read(ctx):
    labels = ctx["profile"].get("labels", {})
    t, frames = labels.get("mesh.to_host"), labels.get("unit.extract", {}).get("count", 0)
    if ctx["loop"] != "extract2d" or t is None or not frames:
        return None
    return 1e3 * t["device_busy_s"] / frames
