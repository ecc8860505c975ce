"""Every cell's whole run at a tiny size on the CPU, the program on its
kernels' plain versions: the plain reference agrees with it (`correct`),
a traced run reads its per-layer metrics, and the run loads no module of
JAX or of the JAX package (checked in a fresh process)."""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

from conftest import CPU_RATES, ROOT, tiny_cell, with_held

CELLS = ["room3dgs-train", "room2dgs-train", "room3dgs-render"]  # listed and held


def run_tiny(workload, seed, trace, device, hooks=None, seconds=1.0):
    from bench_port import harness

    cell = tiny_cell(workload)
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_cell(cell, seed, seconds, trace, device, time.time(), tmp,
                                dict(hooks or {}, peaks=CPU_RATES))


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_plain_program(workload, cpu):
    res = run_tiny(workload, 2**31 + 12345, False, cpu)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_layers(workload, cpu):
    from bench_port import harness

    res = run_tiny(workload, 77, True, cpu)
    names = {m["name"] for m in harness.cell_of(workload, with_held(harness.spec()))["per_layer"]}
    got = set(res["metrics"])
    # no kernel and no device time on the CPU: the rooflines stay silent
    assert got <= names and {n for n in names if "roofline" not in n} <= got
    assert res["correct"] and "breakdown" in res and res["device"]["window_s"] > 0


def test_no_jax_module_in_a_run():
    code = (
        "import sys, time, tempfile, torch; sys.path.insert(0, %r); "
        "sys.path.insert(0, %r); from conftest import tiny_cell, CPU_RATES; "
        "from bench_port import harness; "
        "res = harness.run_cell(tiny_cell('room3dgs-train'), 5, 0.5, False, "
        "torch.device('cpu'), time.time(), tempfile.mkdtemp(), {'peaks': CPU_RATES}); "
        "print(harness.loaded_forbidden(), sorted(m for m in sys.modules if "
        "m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'scorp_tpu')))"
    ) % (ROOT, os.path.dirname(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_no_cuda_no_result(tmp_path):
    """Without a CUDA device a run exits 3 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_port", "run.py"),
                          "--workload", "room3dgs-render", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and bench_port/, a run fails."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "room3dgs-render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    json.dumps(out.returncode)


def test_traced_labels_time_each_range(cpu):
    """A traced run times each labelled range on the host (and on the
    device where there is one), so a reader of one part's time is a file
    alone."""
    import torch

    from bench_port.devtrace import labels, traced

    label = labels(True)

    def unit():
        with label("unit.a"):
            torch.ones(256).cumsum(0)
        with label("unit.b"):
            torch.ones(256).sum()

    got = traced(unit, 3, "unit.window", cpu)["labels"]
    assert set(got) == {"unit.a", "unit.b"}
    assert all(t["count"] == 3 and t["host_s"] > 0 for t in got.values())
