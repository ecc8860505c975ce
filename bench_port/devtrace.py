"""What a traced run reads from the device and the host: a torch.profiler
trace of a few units of work (the device's busy intervals, each kernel's
time, each labelled range's host and device time, the idle gaps with what
the host was doing), the ATen ops a unit dispatches, and what the host gave
a window (`host_probe`). `dispatched_ops` is `chip_smoke.py:dispatched_ops`,
copied."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


NAME_CHARS = 160  # a kernel's demangled name is cut to this in the breakdown


def labels(on: bool):
    """The harness's labels around the phases of a unit of work: ranges of
    torch.profiler in a traced run, nothing in a run that is not."""
    if on:
        from torch.profiler import record_function

        return record_function
    return lambda name: contextlib.nullcontext()


def dispatched_ops(fn) -> int:
    """ATen ops that one call of fn() dispatches: its host-side work."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with _Count() as counter:
        fn()
    return counter.n


def _union(intervals):
    total, cur_s, cur_e, merged = 0.0, None, None, []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


def traced(fn, units: int, label: str, device) -> dict:
    """Run fn() `units` times under torch.profiler -> {window_s, busy_s,
    kernels: [(name, device seconds)], labels (see label_times), breakdown}.
    The window is the host's time from the first unit's start to the
    device's end; busy is the union of the kernel, copy and set intervals
    inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    with profile(activities=acts) as prof:
        with record_function(label):
            for _ in range(units):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.events()
    outer = [e for e in events if e.name == label]
    w0 = min(e.time_range.start for e in outer)
    w1 = max(e.time_range.end for e in outer)
    # the device's own work; the harness's labels (record_function) also
    # appear on the device's timeline as annotations spanning their work
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and not e.name.startswith("unit.")]
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev_ev
                 if e.time_range.end > w0 and e.time_range.start < w1]
    busy_us, merged = _union(intervals)
    per_kernel = defaultdict(float)
    for e in dev_ev:
        per_kernel[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    # idle gaps: the innermost host op (and the harness's label around it)
    # running at each gap's middle
    host = [e for e in events if e.device_type != DeviceType.CUDA and e.name != label]
    gaps = []
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    by_name = defaultdict(float)
    starts = sorted(host, key=lambda e: e.time_range.start)
    active, i = [], 0
    for a, b in gaps:  # in time order: one sweep over the host events
        mid = 0.5 * (a + b)
        while i < len(starts) and starts[i].time_range.start <= mid:
            active.append(starts[i])
            i += 1
        active = [e for e in active if e.time_range.end >= mid]
        phase = [e for e in active if e.name.startswith("unit.")]
        ops = [e for e in active if not e.name.startswith("unit.")]
        inner = max(ops, key=lambda e: e.time_range.start) if ops else None
        name = f"{phase[-1].name if phase else 'between units'}: {inner.name if inner else 'python'}"
        by_name[name] += (b - a) / 1e6
    window_s = (w1 - w0) / 1e6
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "labels": label_times(events, label, merged),
        "breakdown": {
            "device_ops": [[k[:NAME_CHARS], v] for k, v in kernels[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def label_times(events, outer: str, merged: list) -> dict:
    """{range name: {count, host_s, device_span_s, device_busy_s}} of every
    record_function range in the trace (the harness's `unit.*` labels and
    any the program opens), the outer window's label left out. host_s sums
    the range's host time; device_span_s the time its work spans on the
    device (the range's annotation on the device's timeline), and
    device_busy_s the device's busy time inside those spans (`merged`: the
    busy intervals, sorted and disjoint). A reader of one part's time reads
    it here, by the range's name."""
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        if not getattr(e, "is_user_annotation", False) or e.name == outer:
            continue
        t = out.setdefault(e.name, dict(count=0, host_s=0.0, device_span_s=0.0,
                                        device_busy_s=0.0))
        s, f = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            t["device_span_s"] += (f - s) / 1e6
            t["device_busy_s"] += sum(max(0.0, min(b, f) - max(a, s)) for a, b in merged
                                      if b > s and a < f) / 1e6
        else:
            t["count"] += 1
            t["host_s"] += (f - s) / 1e6
    return out


def clock() -> float:
    return time.perf_counter()


def _task_stat(path: str) -> list:
    """The fields of a /proc .../stat file after the command's name: field n
    of proc(5) is at [n - 3]."""
    with open(path) as f:
        return f.read().rsplit(")", 1)[1].split()


def host_probe(threads: dict | None = None) -> dict:
    """What the host has given this process so far: its CPU seconds, the
    calling thread's, the machine's stolen ticks (a virtual machine's
    cores lent to others), the calling thread's preemptions, the process's
    minor page faults (fresh pages touched), and the CPU
    each named thread ({name: native id}) last ran on with its CPU seconds.
    Read at a window's two ends; `host_note` says what changed."""
    import os

    snap = dict(t=time.perf_counter(), proc_cpu=time.process_time(),
                main_cpu=time.thread_time(), cpus={}, thread_cpu={})
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
        snap["steal"], snap["ticks"] = ticks[7], sum(ticks)
        with open("/proc/thread-self/status") as f:
            for line in f:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    snap["preempted"] = int(line.split()[1])
        hz = os.sysconf("SC_CLK_TCK")
        snap["faults"] = int(_task_stat("/proc/self/stat")[7])
        named = dict(threads or {})
        snap["cpus"]["main"] = int(_task_stat("/proc/thread-self/stat")[36])
        for name, tid in named.items():
            st = _task_stat(f"/proc/self/task/{tid}/stat")
            snap["cpus"][name] = int(st[36])
            snap["thread_cpu"][name] = (int(st[11]) + int(st[12])) / hz
    except (OSError, ValueError, IndexError):
        pass
    return snap


def host_note(a: dict, b: dict, units: int) -> str:
    """The host's share of a window between two probes, per unit of work."""
    import os

    per = 1e3 / max(units, 1)
    parts = [f"main thread cpu {per * (b['main_cpu'] - a['main_cpu']):.3f} ms/unit",
             f"process cpu {per * (b['proc_cpu'] - a['proc_cpu']):.3f} ms/unit"]
    for name, s in b["thread_cpu"].items():
        parts.append(f"{name} thread cpu {per * (s - a['thread_cpu'].get(name, 0.0)):.3f} ms/unit")
    if "ticks" in a and "ticks" in b and b["ticks"] > a["ticks"]:
        parts.append(f"steal {100.0 * (b['steal'] - a['steal']) / (b['ticks'] - a['ticks']):.3f}%"
                     " of the machine's ticks")
    if "faults" in a and "faults" in b:
        parts.append(f"minor page faults {(b['faults'] - a['faults']) / max(units, 1):.1f}/unit")
    if "preempted" in a and "preempted" in b:
        parts.append(f"main thread preempted {b['preempted'] - a['preempted']} times")
    parts.append(f"cpus at start {a['cpus']} at end {b['cpus']}")
    parts.append(f"affinity {len(os.sched_getaffinity(0))} cpus")
    return "host: " + "; ".join(parts)
