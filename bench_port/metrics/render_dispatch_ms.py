"""Renderer layer (render.py render): the host's ms a viewer frame inside
the program's `render` span: the host's dispatch of the frame. The render
waits on the device only where it uploads the viewer's background, first
thing, when the loop's copy of the previous image to host has left the
device idle."""
from bench_port.metrics._spans import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "render", "host_s")
