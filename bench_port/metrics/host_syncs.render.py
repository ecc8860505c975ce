"""Renderer layer (render.py render, render2d.py render2d): the host's waits
for the device a viewer frame, the program's `sync.*` spans a frame (the
background's upload, the read of the frame's key total, and in 2DGS the
camera's inverse in `depth_to_normal`)."""
from bench_port.metrics._syncs import per_unit


def read(ctx):
    w = per_unit(ctx, "render")
    return None if w is None else w[0]
