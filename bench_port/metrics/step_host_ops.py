"""Step layer (train/step.py, train/step2d.py): ATen ops dispatched per
trainer iteration, counted after the window over a few iterations."""


def read(ctx):
    return ctx["host_ops"] if ctx["loop"] == "train" else None
