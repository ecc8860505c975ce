"""Shared by the span readers: one of the program's spans
(`scorp_tpu_torch/utils/trace.py`) in a traced run of the viewer loop, per
frame, from the profile's labelled ranges (`devtrace.label_times`).

The divisor is the number of frames the profile holds: the count of the
loop's own `unit.render` label. On the device a span's footprint runs
from the first to the last kernel launched inside it and outside its
child spans (CUPTI ties a kernel to the innermost open range), so a
parent's device time holds a child's only where the parent's own kernels
come before and after it."""


def per_frame_ms(ctx: dict, span: str, field: str = "device_busy_s"):
    """1e3 x the span's `field` (host_s, device_span_s or device_busy_s)
    over the traced frames; None outside the viewer loop or where the run
    opened no such span."""
    labels = ctx["profile"].get("labels", {})
    t, frames = labels.get(span), labels.get("unit.render", {}).get("count", 0)
    if ctx["loop"] != "render" or t is None or not frames:
        return None
    return 1e3 * t[field] / frames
