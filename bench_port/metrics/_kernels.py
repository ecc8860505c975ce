"""Shared by the roofline readers: a kernel's device seconds in a traced
run, found by its function name as a whole word of the demangled name."""

import re


def device_seconds(ctx: dict, function: str) -> float:
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(function) + r"(?![A-Za-z0-9_])")
    return sum(s for name, s in ctx["profile"]["kernels"] if pat.search(name))


def roofline_pct(ctx: dict, loop: str, primitive: str, part: str, function: str):
    """100 x the work model's least seconds of `part` over the traced units
    / the kernel's device seconds; None where the cell has no such kernel."""
    if ctx["loop"] != loop or ctx["primitive"] != primitive or part not in ctx["least_s"]:
        return None
    t = device_seconds(ctx, function)
    if t <= 0:
        return None
    return 100.0 * ctx["least_s"][part] / t
