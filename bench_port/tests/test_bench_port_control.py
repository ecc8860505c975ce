"""The checks reject what they must, at a size the CPU holds: the
reference itself in the program's place with its blend in bfloat16 (the
control), and the timed path broken underneath a whole run: a training
step that returns its state unchanged or moves one group double, a frame
altered where it is produced. A single-view step has no batch to halve and one chip no
exchange to leave out, so those faults have no test."""

import tempfile

import pytest
import torch

from bench_port import harness, room
from bench_port.loops import render as render_loop
from bench_port.loops import train as train_loop
from bench_port.reference import camera, raster_of
from bench_port.reference import train as ref_train
from conftest import tiny_cell
from test_bench_port_cells import run_tiny


@pytest.mark.parametrize("workload", ["room3dgs-train", "room2dgs-train"])
def test_bfloat16_control_fails_training(workload, cpu):
    cell = tiny_cell(workload)
    cfg = cell["config"]
    with tempfile.TemporaryDirectory() as tmp:
        ps = room.write_capture(tmp, cfg, cpu)
        steps = [dict(pose=ps[i], bg=[0.1 * i, 0.5, 0.9], iteration=25001 + i,
                      image_path=f"{tmp}/images/{ps[i]['name']}.jpg") for i in (1, 2, 3)]

        def start():
            p, v, a, _ = room.state_tensors(cfg, 9, cpu)
            return dict(params=p, v=v, alive=a, step=25000)

        ref = ref_train.follow(start(), steps, cfg, cpu)
        ctl = ref_train.follow(start(), steps, cfg, cpu, dtype=torch.bfloat16)
    got = train_loop.compare(dict(losses=ctl["losses"], first_grad=ctl["grad_norms"],
                                 change=ctl["change_norms"], first_grad_rows=ctl["grad_rows"],
                                 change_rows=ctl["change_rows"]),
                             ref, cell["limits"].get("edge_on_cos_below"))
    ok, checks = harness.judge(got, cell["limits"])
    assert not ok, checks


def test_bfloat16_control_fails_render(cpu):
    cell = tiny_cell("room3dgs-render")
    cfg = cell["config"]
    params, _, alive, _ = room.state_tensors(cfg, 9, cpu)
    poses = room.poses(cfg)
    kept = []
    for view in (0, 5):
        cam = camera.camera(poses[view], cfg["width"], cfg["height"], cpu)
        f = raster_of("3dgs").render(params, alive, cam, torch.zeros(3), dtype=torch.bfloat16)
        a = f.alpha
        kept.append(dict(view=view, image=f.color.numpy(), alpha=a,
                         depth=torch.where(a > 0, f.depth / torch.where(a > 0, a, 1.0), 0.0)))
    got = render_loop.check(cell, 9, dict(kept=kept, poses=poses), cpu)
    ok, checks = harness.judge(got, cell["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", ["room3dgs-train", "room2dgs-train"])
def test_a_step_that_returns_its_state_fails(workload, cpu):
    def unchanged(step):
        def broken(state, adam, *a, **k):
            _, _, metrics = step(state, adam, *a, **k)
            return state, adam, metrics
        return broken

    res = run_tiny(workload, 3, False, cpu, {"step": unchanged})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["room3dgs-train", "room2dgs-train"])
def test_a_step_that_moves_the_positions_double_fails(workload, cpu):
    """A fault in one group's update alone (xyz moved twice as far) fails:
    the numbers compared reach the worst group, not only the median."""
    def doubled(step):
        def broken(state, adam, *a, **k):
            new, adam, metrics = step(state, adam, *a, **k)
            old = state.params["xyz"]
            params = dict(new.params, xyz=old + 2.0 * (new.params["xyz"] - old))
            return new._replace(params=params), adam, metrics
        return broken

    res = run_tiny(workload, 3, False, cpu, {"step": doubled})
    assert not res["correct"], res["checks"]


def test_facing_cos_finds_edge_on_surfels(cpu):
    """The rule that leaves rows out of the 2DGS facing gaps: a surfel whose
    normal is across the ray reads 0, one facing the camera 1."""
    from bench_port.reference import raster2d

    s = 0.5 ** 0.5
    params = dict(xyz=torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0]]),
                  rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0], [s, s, 0.0, 0.0]]))
    cos = raster2d.facing_cos(params, dict(center=torch.zeros(3)))
    assert torch.allclose(cos, torch.tensor([1.0, 0.0]), atol=1e-6)


def test_an_altered_frame_fails(cpu):
    def altered(render):
        def broken(*a, **k):
            out = render(*a, **k)
            out["render"] = out["render"] * 1.01
            return out
        return broken

    res = run_tiny("room3dgs-render", 3, False, cpu, {"render": altered})
    assert not res["correct"], res["checks"]
