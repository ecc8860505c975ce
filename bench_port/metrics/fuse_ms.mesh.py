"""Mesh layer (pipeline/mesh.py TsdfVolume.integrate): the device's busy ms
a fused view inside the program's `mesh.fuse` span (kernel T on the card),
over the views of a traced run of the fusion loop (the count of the loop's
own `unit.fuse` label)."""


def read(ctx):
    labels = ctx["profile"].get("labels", {})
    t, views = labels.get("mesh.fuse"), labels.get("unit.fuse", {}).get("count", 0)
    if ctx["loop"] != "fuse2d" or t is None or not views:
        return None
    return 1e3 * t["device_busy_s"] / views
