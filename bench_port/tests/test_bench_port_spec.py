"""BENCHMARK.json against the form the benchmark file must have, and every piece of every
cell found by name."""

import json
import os
import re

import pytest

from conftest import ROOT, with_held

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("held", [False, True])
def test_keys_names_and_units(held):
    """BENCHMARK.json, and it with the held cells' entries added."""
    b = with_held(spec()) if held else spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    for m in b["end_to_end"]:
        # a held metric gets its bound from the runs of the PR that lists it
        assert (held and m["bound"] is None) or 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("held", [False, True])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(held):
    b = with_held(spec()) if held else spec()
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics", "work"])
def test_pieces_found_by_name(kind):
    from bench_port import harness

    b = with_held(spec())
    for w in b["workloads"]:
        cell = harness.cell_of(w["name"], b)
        if kind == "metrics":
            for m in cell["per_layer"]:
                assert callable(harness.reader(m["name"]).read)
        elif kind == "work":
            for parts in cell["config"]["work"].values():
                for p in parts:
                    assert callable(harness.work_part(p).cost)
        elif kind == "configs":
            assert cell["config"]["primitive"] in ("3dgs", "2dgs")
            held = cell["config"].get("host_malloc", {})
            assert set(held) <= set(harness.MALLOPT)
            assert not held or "host_malloc" in cell["config"]["assumed"]
        elif kind == "traffic":
            assert cell["traffic"]["loop"] in ("train", "render")
            assert callable(harness.loop_of(cell["traffic"]["loop"]).run)
        else:
            assert set(cell["limits"]["limits"]) and all(
                v > 0 for v in cell["limits"]["limits"].values())
    assert harness.peaks("NVIDIA H100 80GB HBM3")["f32_flops_per_s"] == 67e12
