"""The JSON summary line of a long training run, read from the trainer's
`log` (apps/train_3dgs.training) and the final PLY."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.plyio import load_gaussian_ply

PLY_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def split_trainer_args(argv: list[str]) -> tuple[list[str], list[str]]:
    """(the run's own arguments, the arguments after `--` for the trainer)."""
    if "--" in argv:
        i = argv.index("--")
        return argv[:i], argv[i + 1:]
    return argv, []


def eval_iterations(candidates: tuple[int, ...], iters: int) -> list[int]:
    """The run's evaluation iterations up to `iters`, and `iters` itself, so
    that the summary always holds the final test PSNR."""
    return sorted({i for i in candidates if i <= iters} | {iters})


def summarize(name: str, log: dict, state, ply: str, iterations: int, wall_s: float,
              device: torch.device) -> dict:
    """The run's summary. Densify rounds are (iteration, alive before,
    candidates, alive after, dropped candidates); capacity growths
    (iteration, old, new); raster regrows (iteration, max_keys,
    stream_keys); SH-degree steps (iteration, degree); training key drops
    (iteration, keys) for the iterations that dropped any; evaluation key
    drops (iteration, keys over the views).
    The final count and the non-finite rows (per field) are the saved PLY's,
    written before the last iteration's densify round; alive counts change
    only in densify rounds, so their peak over the rounds is exact."""
    rounds = [list(r) for r in log["densify"]]
    g = load_gaussian_ply(ply)
    alive = [g.n, int(state.num_alive())] + [r[1] for r in rounds[:1]] + [r[3] for r in rounds]
    losses = np.asarray(log["loss"], np.float64)
    return {
        "run": name,
        "device": str(device),
        "iterations": iterations,
        "wall_s": wall_s,
        "it_per_s": iterations / max(wall_s, 1e-9),
        "final_alive": g.n,
        "peak_alive": max(alive),
        "densify": rounds,
        "capacity_growths": [list(c) for c in log["capacity"]],
        "raster_regrows": [list(r) for r in log["raster_keys"]],
        "sh_degree_steps": [list(d) for d in log["sh_degree"]],
        "dropped_keys_train": [[i + 1, d] for i, d in enumerate(log["dropped_keys"]) if d],
        "dropped_keys_eval": [list(e) for e in log["eval_dropped_keys"]],
        "eval": [{"iteration": it, **{k: {"l1": l1, "psnr": p} for k, (l1, p) in res.items()}}
                 for it, res in log["eval"]],
        "nonfinite_losses": int((~np.isfinite(losses)).sum()),
        "nonfinite_rows": {k: int((~np.isfinite(getattr(g, k).reshape(g.n, -1))).any(axis=1).sum())
                           for k in PLY_FIELDS},
        "peak_device_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                            if device.type == "cuda" else None),
    }


def train(trainer_main, argv: list[str], device: torch.device):
    """trainer_main(argv) with the device's peak memory reset before it ->
    (its result, wall seconds)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    result = trainer_main(argv)
    return result, time.time() - t0


def final_ply(model_dir: str, iterations: int) -> str:
    return os.path.join(model_dir, "point_cloud", f"iteration_{iterations}", "point_cloud.ply")
