"""Renderer layer (render.py render, render2d.py render2d): the host's ms a
viewer frame inside the program's `sync.*` spans, the time it is held
waiting for the device (see host_syncs.render for the sites)."""
from bench_port.metrics._syncs import per_unit


def read(ctx):
    w = per_unit(ctx, "render")
    return None if w is None else 1e3 * w[1]
