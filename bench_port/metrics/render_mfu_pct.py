"""Renderer layer: the work model's least seconds of one frame (its parts
with the copy to host, over the traced frames, per frame) over the
window's measured seconds per frame, in percent."""


def read(ctx):
    if ctx["loop"] != "render" or not ctx["traced_units"]:
        return None
    least = sum(ctx["least_s"].values()) / ctx["traced_units"]
    return 100.0 * least / (ctx["window_s"] / ctx["units"])
