"""Input layer (apps/train_3dgs.py CameraSampler, GtDeviceCache): the
host's mean wait per iteration of the window for the next view's decoded
image and its upload (the span around sampler.next() and gt_cache.get())."""


def read(ctx):
    if ctx["loop"] != "train" or not ctx["gt_wait_s"]:
        return None
    return 1e3 * sum(ctx["gt_wait_s"]) / len(ctx["gt_wait_s"])
