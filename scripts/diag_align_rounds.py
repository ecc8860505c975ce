"""Why the alignment rounds of chip_smoke.py's phases 12 and 13 converge or
not: both phases rehearsed on the CPU at a reduced size, with each round's
pose and the share of its lifted pairs that the true transform explains.

The proxy is the object cluster scaled 0.6, rotated 0.5 rad about z and
shifted (x -> 0.6 Rz x + t); the aligned proxy should be the cluster. Before
each round this prints the rotation error and scale of the transform the
rounds have applied so far (before round 0: the coarse init), and the
share of the round's lifted pairs whose proxy-side point, mapped back to
the cluster's frame, lies within the app's RANSAC threshold of its
scene-side point.

    python scripts/diag_align_rounds.py [--factor 0.25] [--matcher13 orb]

`--factor` scales the smoke's 1600x1066 views (n by its square, the scales
by its inverse, as in the verify notes). The mesh checks run at 64^3;
launch and 256^3 checks fail on the CPU by design and are only listed. About 4 minutes at 0.25 on 4 threads.
"""

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from scorp_tpu_torch.apps import align_2dgs_clpe_9dof as align2d_app  # noqa: E402
from scorp_tpu_torch.apps import align_3dgs_clpe_9dof as align_app  # noqa: E402
from scorp_tpu_torch.apps import extract_mesh  # noqa: E402
from scorp_tpu_torch.core.plyio import load_gaussian_ply  # noqa: E402

RZ = np.array([[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1.0]])
SHIFT = np.array([0.8, -0.5, 0.4])


def cpu_only(factor: float) -> list:
    """Point the smoke's card-only helpers at host equivalents; returns the
    list that collects the failed checks."""
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0

    def host_ms(fn, reps):
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3

    cs.cuda_ms = host_ms
    cs.device_profile = lambda fn, reps: (host_ms(fn, reps), [])
    cs.host_syncs = lambda fn: 0
    cs.counted_syncs = lambda fn: (fn(), 0)
    failed = []

    def check(cond, what):
        if not cond:
            failed.append(what)

    cs.check = check
    draw = cs.bench_scene_draw

    def scaled_draw(n, seed):
        out = list(draw(n, seed))
        out[2] = out[2] / factor
        return tuple(out)

    cs.bench_scene_draw = scaled_draw
    main = extract_mesh.main
    extract_mesh.main = lambda argv: main(list(argv) + ["--mesh_res", "64"])
    cs.TSDF_RES = 64  # phase 13's contracted-grid check, at the same size
    return failed


def analyse(paths: dict):
    """Wrap align's get_pcd_pair to print each round's pose and inlier share;
    `paths` holds the written proxy, the cluster and whether the proxy was
    truncated at opacity 0.1 before the alignment."""
    real = align_app.get_pcd_pair

    def pair(gaussians, *a, **kw):
        pcd_o, pcd_r = real(gaussians, *a, **kw)
        proxy = load_gaussian_ply(paths["proxy"])
        keep = np.ones(proxy.n, bool)
        if paths["truncated"]:
            keep = 1 / (1 + np.exp(-proxy.opacity[:, 0])) >= 0.1
        src = np.concatenate([proxy.xyz[keep], np.ones((int(keep.sum()), 1))], 1)
        A = np.linalg.lstsq(src, gaussians.xyz.astype(np.float64), rcond=None)[0].T
        u, sv, vt = np.linalg.svd(A[:, :3] @ (0.6 * RZ))
        rot = np.arccos(np.clip((np.trace(u @ vt) - 1) / 2, -1, 1))
        written = np.linalg.solve(A[:, :3], (pcd_r - A[:, 3]).T).T
        in_cluster = (written - SHIFT) @ RZ / 0.6
        cluster = load_gaussian_ply(paths["cluster"]).xyz
        thr = float((cluster.max(0) - cluster.min(0)).mean() / 10)
        err = np.linalg.norm(in_cluster - pcd_o, axis=1)
        print(f"  [diag] {paths['phase']} round {kw['iteration']}: before it rotation error "
              f"{rot:.4f} rad, scale {np.cbrt(np.prod(sv)):.4f}; {np.mean(err < thr):.3f} of "
              f"{len(pcd_o)} lifted pairs within {thr:.3f} of the true transform's")
        return pcd_o, pcd_r

    align_app.get_pcd_pair = pair


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--factor", type=float, default=0.25)
    ap.add_argument("--matcher13", default="orb", help="phase 13's matcher backend")
    args = ap.parse_args()
    torch.set_num_threads(4)
    f = args.factor
    cs.WORK = os.path.join(ROOT, "build", "diag_align")
    shutil.rmtree(cs.WORK, ignore_errors=True)
    os.makedirs(cs.WORK)
    failed = cpu_only(f)
    smoke_args = argparse.Namespace(seed=0, n=int(250_000 * f * f), width=int(1600 * f),
                                    height=int(1066 * f))
    real_align = align2d_app.align
    align2d_app.align = lambda *a, **kw: real_align(*a, **{**kw,
                                                           "matcher_backend": args.matcher13})
    paths = {}
    analyse(paths)
    cpu = torch.device("cpu")
    paths.update(phase="phase 12", truncated=False,
                 proxy=os.path.join(cs.WORK, "scorp_model", "generated", "obj.ply"),
                 cluster=os.path.join(cs.WORK, "scorp_model", "gs_seg", "obj.ply"))
    cs.phase_scorp(smoke_args, cpu)
    paths.update(phase="phase 13", truncated=True,
                 proxy=os.path.join(cs.WORK, "proxies", "obj.ply"),
                 cluster=os.path.join(cs.WORK, "scorp2d_model", "gs_seg", "obj.ply"))
    cs.phase_scorp2d(smoke_args, cpu)
    print("checks that failed on the CPU:", failed)
    shutil.rmtree(cs.WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
