"""Phase 13's 2DGS alignment rounds (`chip_smoke.py:phase_scorp2d`) against
the JAX package's, on the CPU at a reduced size (marked `slow`; `pytest -m
slow`): phases 12 and 13 rehearsed as `scripts/diag_align_rounds.py` does
(the smoke's 1600x1066 views at a quarter of the width, n by 1/16, the
scales by 4), and beside the port's `align_2dgs_clpe_9dof.align` (ORB in
PyTorch, `pipeline/orb.py`) the JAX app's on a copy of the same model
directory, matched by cv2's ORB (`CV2Matcher("orb")`). After each round the
aligned proxy is held against the true transform (the proxy is the object
cluster scaled 0.6, rotated 0.5 rad about z and shifted): its centroid
error, its scale (true 1/0.6) and its rotation error, printed for both
packages."""

import argparse
import os
import shutil
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from scorp_tpu.apps import align_2dgs_clpe_9dof as jalign2d
from scorp_tpu.config import ModelParams as JModelParams
from scorp_tpu_torch.apps import align_2dgs_clpe_9dof as talign2d
from scorp_tpu_torch.apps import extract_mesh
from scorp_tpu_torch.core.plyio import load_gaussian_ply

FACTOR = 0.25
RZ = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1.0]])


def round_errors(model_dir: str, rounds: int) -> list[dict]:
    """Each round's aligned proxy (generated_aligned/obj_<round>.ply) against
    the cluster (gs_seg/obj.ply), as phase 13 measures it: the least-squares
    affine map from the truncated proxy as written, split into rotation and
    scale."""
    seg = load_gaussian_ply(os.path.join(model_dir, "gs_seg", "obj.ply")).xyz
    src = load_gaussian_ply(os.path.join(model_dir, "generated", "obj.ply")).xyz
    src = np.concatenate([src, np.ones((len(src), 1))], 1).astype(np.float64)
    out = []
    for it in range(rounds):
        xyz = load_gaussian_ply(os.path.join(model_dir, "generated_aligned",
                                             f"obj_{it}.ply")).xyz
        affine = np.linalg.lstsq(src, xyz.astype(np.float64), rcond=None)[0][:3].T
        u, sv, vt = np.linalg.svd(affine)
        out.append({"round": it,
                    "centroid_err": float(np.linalg.norm(xyz.mean(0) - seg.mean(0))),
                    "scale": float(np.cbrt(np.prod(sv))),
                    "rot_err": float(np.arccos(np.clip((np.trace(u @ vt @ RZ) - 1) / 2,
                                                       -1, 1)))})
    return out


@pytest.mark.slow
def test_align_2dgs_rounds_beside_jax(tmp_path, monkeypatch):
    """~12 minutes on 4 threads."""
    torch.set_num_threads(4)
    monkeypatch.setattr(cs, "WORK", str(tmp_path / "smoke"))
    os.makedirs(cs.WORK)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)

    def host_ms(fn, reps):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3

    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    monkeypatch.setattr(cs, "device_profile", lambda fn, reps: (host_ms(fn, reps), []))
    monkeypatch.setattr(cs, "host_syncs", lambda fn: 0)
    monkeypatch.setattr(cs, "counted_syncs", lambda fn: (fn(), 0))
    monkeypatch.setattr(cs, "check", lambda cond, what: None)  # the launch checks need a card
    draw = cs.bench_scene_draw

    def scaled_draw(n, seed):
        out = list(draw(n, seed))
        out[2] = out[2] / FACTOR
        return tuple(out)

    monkeypatch.setattr(cs, "bench_scene_draw", scaled_draw)
    mesh_main = extract_mesh.main
    monkeypatch.setattr(extract_mesh, "main",
                        lambda argv: mesh_main(list(argv) + ["--mesh_res", "64"]))
    monkeypatch.setattr(cs, "TSDF_RES", 64)  # phase 13's contracted-grid check, the same size
    models = {}
    port_align = talign2d.align

    def both(dataset, pipeline, name, **kw):
        jmodel = str(tmp_path / "jax_model")
        shutil.copytree(dataset.model_path, jmodel)
        jdataset = JModelParams(source_path=dataset.source_path, model_path=jmodel, eval=True,
                                split_yml_name=dataset.split_yml_name).finalize()
        jalign2d.align(jdataset, None, name, num_iterations=kw["num_iterations"],
                       opt_12dof_iterations=kw["opt_12dof_iterations"],
                       rotations_path=str(tmp_path / "jax_rotations"), matcher_backend="orb")
        models.update(port=dataset.model_path, jax=jmodel)
        return port_align(dataset, pipeline, name, **kw)

    monkeypatch.setattr(talign2d, "align", both)
    smoke_args = argparse.Namespace(seed=0, n=int(250_000 * FACTOR ** 2),
                                    width=int(1600 * FACTOR), height=int(1066 * FACTOR))
    cpu = torch.device("cpu")
    cs.phase_scorp(smoke_args, cpu)
    cs.phase_scorp2d(smoke_args, cpu)
    errs = {pkg: round_errors(models[pkg], cs.ALIGN2D_ROUNDS) for pkg in ("port", "jax")}
    for pkg, rows in errs.items():
        for r in rows:
            print(f"{pkg} after round {r['round']}: centroid error {r['centroid_err']:.4f}, "
                  f"scale {r['scale']:.4f} (true {1 / 0.6:.4f}), rotation error "
                  f"{r['rot_err']:.4f} rad")
    assert all(len(rows) == cs.ALIGN2D_ROUNDS for rows in errs.values())
    # neither package recovers the coarse init's rotation in its first two
    # rounds (measured: the port 1.4191 / 2.3663 rad, JAX 1.3035 / 2.7422)
    assert all(r["rot_err"] > 1.0 for rows in errs.values() for r in rows[:2]), errs
