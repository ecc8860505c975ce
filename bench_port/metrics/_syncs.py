"""Shared by the host-wait readers: the program's `sync.*` spans
(`scorp_tpu_torch/utils/trace.py`), each one place where the host waits for
the device, in a traced run. Every `sync.`-prefixed label of the profile
(`devtrace.label_times`) adds its count and its host time, and the sums are
divided by the count of the loop's own unit label: `unit.render` in the
viewer loops (their trace context's loop is `render`), `unit.extract` in
the mesh-export loop."""

UNITS = {"render": "unit.render", "extract2d": "unit.extract"}


def per_unit(ctx: dict, loop: str):
    """(waits, host seconds in them) a traced unit of `loop`; None in another
    loop, or where the run opened no `sync.*` span (a program without
    them)."""
    labels = ctx["profile"].get("labels", {})
    units = labels.get(UNITS[loop], {}).get("count", 0)
    waits = [t for name, t in labels.items() if name.startswith("sync.")]
    if ctx["loop"] != loop or not waits or not units:
        return None
    return sum(t["count"] for t in waits) / units, sum(t["host_s"] for t in waits) / units
