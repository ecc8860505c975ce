"""Device layer in the viewer's frames: 100 x (1 - the union of the
device's kernel, copy and set intervals / the profiled window of a few
frames)."""


def read(ctx):
    if ctx["loop"] != "render":
        return None
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
