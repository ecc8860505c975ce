"""Step layer: the work model's least seconds of one trainer iteration
(the sum of its parts, bench_port/work/, over the traced iterations, per
iteration) over the window's measured seconds per iteration, in percent."""


def read(ctx):
    if ctx["loop"] != "train" or not ctx["traced_units"]:
        return None
    least = sum(ctx["least_s"].values()) / ctx["traced_units"]
    return 100.0 * least / (ctx["window_s"] / ctx["units"])
