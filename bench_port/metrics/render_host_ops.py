"""Renderer layer (render.py): ATen ops dispatched per viewer frame (the
render and the copy to host), counted after the window over a few frames."""


def read(ctx):
    return ctx["host_ops"] if ctx["loop"] == "render" else None
