"""Device layer in training: 100 x (1 - the union of the device's kernel,
copy and set intervals / the profiled window of a few iterations)."""


def read(ctx):
    if ctx["loop"] != "train":
        return None
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
