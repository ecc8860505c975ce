"""Multi-process check of the camera-batch scale-out on CPU ranks, the port's
counterpart of `__graft_entry__.dryrun_multichip`.

    python -m scorp_tpu_torch.parallel.dryrun [n]     # n ranks, default 2

Spawns n processes that form a gloo group on 127.0.0.1 and run, on a small
seeded scene with 2 cameras per rank, one `dp_train_step`, one `dp_render`
and one `dp_train_step_2d` on their shards. The parent runs the same three
calls in one process with no group and holds each rank to them: the
states, Adam moments and losses within 1e-6 (the gradients are summed in
another order), the frames equal. Every rank must hold the same bits. Each
process has a hard timeout; on any failure the others are killed. Prints
one line: `dryrun(n): ok, loss=..., alive=...`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..core.camera import look_at_camera
from ..core.plyio import GaussianData
from ..core.sh import rgb_to_sh
from ..ops.raster import RasterConfig
from ..train import OptParams, Opt2DParams, from_gaussian_data, init_adam
from .mesh import free_port, make_group, replicate, shard_batch
from .render_dp import dp_render
from .train_dp import dp_train_step, dp_train_step_2d, stack_cameras

WIDTH, HEIGHT = 64, 48
CFG = RasterConfig(max_keys=1 << 13)


def _scene(n_cams: int, surfel: bool):
    """__graft_entry__.dryrun_multichip's scene (64 Gaussians, capacity 128;
    as surfels their first two scales and random rotations), its orbit of
    `n_cams` cameras and seeded ground truths, on the CPU."""
    rng = np.random.default_rng(0)
    n = 64
    g = GaussianData(
        xyz=rng.uniform(-1, 1, size=(n, 3)).astype(np.float32),
        f_dc=rgb_to_sh(rng.uniform(0.2, 0.8, (n, 3))).reshape(n, 1, 3).astype(np.float32),
        f_rest=np.zeros((n, 15, 3), np.float32),
        opacity=np.full((n, 1), 1.5, np.float32),
        scaling=np.full((n, 2 if surfel else 3), np.log(0.15), np.float32),
        rotation=(rng.normal(size=(n, 4)).astype(np.float32) if surfel
                  else np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))),
    )
    state = from_gaussian_data(g, capacity=128, device="cpu")
    cams = [
        look_at_camera(eye=[2.5 * np.sin(a), 0.5, -2.5 * np.cos(a)], target=[0, 0, 0],
                       up=[0, 1, 0], fovx=0.9, fovy=0.75, width=WIDTH, height=HEIGHT,
                       device="cpu")
        for a in np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    ]
    gt = torch.from_numpy(rng.uniform(0, 1, (n_cams, 3, HEIGHT, WIDTH)).astype(np.float32))
    return state, init_adam(state), stack_cameras(cams), gt


def _calls(n_cams: int, group=None) -> dict:
    """The three calls on this rank's shard (all of it with no group), as
    numpy arrays."""
    out = {}
    bg = torch.zeros(3)
    kw = dict(sh_degree=0, cfg=CFG, width=WIDTH, height=HEIGHT, group=group)
    for tag, step, opt, it, surfel in (("3d", dp_train_step, OptParams(), 1, False),
                                       ("2d", dp_train_step_2d, Opt2DParams(lambda_dist=10.0),
                                        8000, True)):
        state, adam, batch, gt = _scene(n_cams, surfel)
        state, adam = replicate(state, group), replicate(adam, group)
        s, a, m = step(state, adam, shard_batch(batch, group), shard_batch(gt, group), it, bg,
                       opt=opt, **kw)
        for k in s.params:
            out[f"{tag}_param_{k}"] = s.params[k].numpy()
            out[f"{tag}_m_{k}"] = a.m[k].numpy()
            out[f"{tag}_v_{k}"] = a.v[k].numpy()
        for k in ("max_radii2d", "xyz_grad_accum", "denom"):
            out[f"{tag}_{k}"] = getattr(s, k).numpy()
        out[f"{tag}_loss"] = m["loss"].numpy()
        if tag == "3d":
            frames = dp_render(s.params, s.alive, shard_batch(batch, group), bg, **kw)
            out["frames"] = torch.cat(frames, dim=1).numpy()
            out["alive"] = s.alive.numpy()
    return out


def _worker(rank: int, world: int, port: int, out_path: str, timeout: float) -> None:
    with make_group(world, rank, port=port, device="cpu", timeout=timeout) as group:
        np.savez(out_path, **_calls(2 * world, group))


def run(n: int = 2, timeout: float = 120.0) -> tuple[dict, list[dict]]:
    """(the one-process results, each rank's results) of the three calls on
    n gloo ranks; raises if a rank fails or outlives `timeout` seconds."""
    if n < 1:
        raise ValueError("n must be at least 1")
    reference = _calls(2 * n)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.npz") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "scorp_tpu_torch.parallel.dryrun", "--worker", str(r),
             str(n), str(port), paths[r], str(timeout)], env=env)
            for r in range(n)]
        try:
            for p in procs:
                if p.wait(timeout=timeout) != 0:
                    raise RuntimeError(f"a dryrun rank exited with {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for path in paths:
            with np.load(path) as z:
                ranks.append({k: z[k] for k in z.files})
    return reference, ranks


def check(reference: dict, ranks: list[dict]) -> None:
    """Each rank's results bit-equal to rank 0's, and rank 0's to the
    one-process results: frames and integer statistics equal, the rest
    within 1e-6 (losses 1e-5 relative)."""
    for r, got in enumerate(ranks):
        if sorted(got) != sorted(reference):
            raise AssertionError(f"rank {r} returned {sorted(got)}")
        for k, v in got.items():
            if not np.array_equal(v, ranks[0][k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's")
    for k, ref in reference.items():
        got = ranks[0][k]
        if k in ("frames", "alive") or k.endswith(("denom", "max_radii2d")):
            ok = np.array_equal(got, ref)
        elif k.endswith("loss"):
            ok = np.allclose(got, ref, rtol=1e-5, atol=0)
        else:
            ok = np.allclose(got, ref, rtol=0, atol=1e-6)
        if not ok:
            raise AssertionError(f"{k}: the {len(ranks)}-rank result differs from one "
                                 f"process by {np.abs(got - ref).max():.3g}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        rank, world, port, out_path, timeout = argv[1:6]
        torch.set_num_threads(1)
        _worker(int(rank), int(world), int(port), out_path, float(timeout))
        return
    n = int(argv[0]) if argv else 2
    reference, ranks = run(n)
    check(reference, ranks)
    loss = float(ranks[0]["3d_loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"dryrun({n}): ok, loss={loss:.6f}, alive={int(ranks[0]['alive'].sum())}")


if __name__ == "__main__":
    main()
