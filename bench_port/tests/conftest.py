"""CPU tests of the benchmark (run: python -m pytest bench_port/tests -q).
`tiny_cell` shrinks a cell to a size the CPU runs in seconds; the program
then runs its kernels' plain versions."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(n_gaussians=3000, width=96, height=64, n_views=16, test_every=8)
TINY_TRAFFIC = dict(traced_units=2, counted_units=1, warmup_iterations=1, warmup_frames=1,
                    sampled_from_first=4, sampled_frames=2)
CPU_RATES = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12, "pcie_bytes_per_s": 64e9}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


def with_held(benchmark: dict) -> dict:
    """BENCHMARK.json with the entries of held_cells.json added: the cells
    whose files are here but that BENCHMARK.json does not list yet."""
    import json

    with open(os.path.join(os.path.dirname(__file__), "held_cells.json")) as f:
        held = json.load(f)
    return {k: benchmark[k] + held[k] if k in held and isinstance(benchmark[k], list)
            else benchmark[k] for k in benchmark}


def tiny_cell(workload: str) -> dict:
    from bench_port import harness

    cell = harness.cell_of(workload, with_held(harness.spec()))
    cell["config"].update(TINY)
    cell["traffic"].update(TINY_TRAFFIC)
    return cell


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")
