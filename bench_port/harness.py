"""The benchmark's general part: it finds every piece of a cell by name and
runs the cell's loop.

From BENCHMARK.json at the root of the checkout, a workload names its
configuration and its traffic. The pieces, each a file of its own:

  bench_port/configs/<config>.json      the deployment (sizes, recipe)
  bench_port/traffic/<traffic>.json     the mix, read by loops/<loop>.py
  bench_port/limits/<workload>.json     the limits of the numbers `correct` compares
  bench_port/metrics/<metric>.py        a per-layer metric's reader, read(ctx)
  bench_port/work/<part>.py             the work model of one part, cost(shape)
  bench_port/peaks.json                 the published rates of each card

A loop returns the run's measurements; this module adds the device, the
per-layer metrics of a traced run, the check against the limits and the
result line. Nothing here, and nothing a run loads, imports JAX or the JAX
package: `loaded_forbidden` looks once the window has closed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "scorp_tpu")
# mallopt's parameter numbers (malloc.h), by the configuration's names
MALLOPT = {"trim_threshold_bytes": -1, "mmap_threshold_bytes": -3}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_of(name: str, benchmark: dict | None = None) -> dict:
    """Everything a run of workload `name` needs, found by name."""
    b = benchmark if benchmark is not None else spec()
    wl = {w["name"]: w for w in b["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(os.path.join(BENCH_DIR, "configs", wl["config"] + ".json"))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", wl["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    e2e = [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in b["per_layer"] if name in m.get("workloads", [name])]
    return dict(workload=wl, config=cfg, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer)


def _load_file(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader module (bench_port/metrics/<metric>.py)."""
    return _load_file(os.path.join(BENCH_DIR, "metrics", metric + ".py"),
                      "bench_port_metric_" + metric.replace(".", "_"))


def work_part(part: str):
    """A work-model part (bench_port/work/<part>.py)."""
    return _load_file(os.path.join(BENCH_DIR, "work", part + ".py"), "bench_port_work_" + part)


def loop_of(name: str):
    """The loop module that runs a traffic kind (bench_port/loops/<name>.py)."""
    return importlib.import_module(f"bench_port.loops.{name}")


def peaks(kind: str) -> dict:
    table = load_json(os.path.join(BENCH_DIR, "peaks.json"))
    for prefix, rates in table.items():
        if kind.startswith(prefix):
            return rates
    raise KeyError(f"no published peaks for {kind!r} in bench_port/peaks.json")


def least_seconds(parts: list[str], shape: dict, rates: dict) -> dict:
    """{part: least seconds} of one unit of work: each part's operations at
    the f32 rate or its bytes at its link's rate, whichever is longer."""
    out = {}
    for p in parts:
        c = work_part(p).cost(shape)
        link = rates["pcie_bytes_per_s"] if c.get("link") == "pcie" else rates["hbm_bytes_per_s"]
        out[p] = max(c["flops"] / rates["f32_flops_per_s"], c["bytes"] / link)
    return out


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits["limits"].items():
        v = readings.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok &= good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def hold_malloc(cfg: dict) -> None:
    """Hold glibc's malloc parameters where the configuration states them
    (`host_malloc`, {name in MALLOPT: value}; its `assumed` entry says
    why), before any thread or large buffer exists. Left alone, glibc
    moves its mmap and trim thresholds as large blocks are freed, so a
    run's 20 MB host buffers land on reused heap pages in one process and
    on fresh pages, faulted in and zeroed, in the next: on the H100's host
    a viewer frame takes 14 or 21 ms by that alone."""
    held = cfg.get("host_malloc")
    if not held:
        return
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt.restype = ctypes.c_int
    for name, value in held.items():
        libc.mallopt(MALLOPT[name], int(value))


def main(workload: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    cell = cell_of(workload)
    hold_malloc(cell["config"])
    import scorp_tpu_torch  # noqa: F401  (the program under test: without it, no run)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="bench_port-")
    try:
        result = run_cell(cell, seed, seconds, trace, device, t0, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if result is None:
        return 4
    print(json.dumps(result))
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             tmp: str, hooks: dict | None = None) -> dict | None:
    """One run -> the result object, or None after naming on standard error
    a forbidden module that the run loaded. `hooks` lets the tests break
    the timed path (see tests/test_bench_port_control.py)."""
    import torch

    loop = loop_of(cell["traffic"]["loop"])
    out = loop.run(cell, seed, seconds, trace, device, t0, tmp, hooks or {})
    bad = loaded_forbidden()
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}", file=sys.stderr)
        return None
    readings = loop.check(cell, seed, out, device)
    ok, checks = judge(readings, cell["limits"])
    on_cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        rates = peaks(kind) if on_cuda else (hooks or {}).get("peaks")
        ctx = loop.trace_context(cell, seed, out, device, rates)
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
        result_extra = {"breakdown": ctx["profile"]["breakdown"]}
        print(f"bench_port: peaks {rates}", file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
        result_extra = {}
    print(f"bench_port: card {power_limit() if on_cuda else 'cpu'}", file=sys.stderr)
    for line in out.get("notes", []):
        print("bench_port: " + line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return {"correct": ok, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev, **result_extra, "checks": checks}
