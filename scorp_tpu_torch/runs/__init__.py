"""Long training runs on synthetic COLMAP room scenes, the port's
counterparts of the JAX package's `scripts/convergence_run.py` and
`scripts/densify_scale_run.py`: each builds its scene (ground truth rendered
through `render`, so through kernels K1, the key sort and K2 on the card),
runs `apps.train_3dgs` for the length users train (30,000 iterations by
default) and prints one JSON summary line (`summary.summarize`).

    python -m scorp_tpu_torch.runs.convergence_run [outdir] [--iters N] [--device cuda]
    python -m scorp_tpu_torch.runs.densify_scale_run [outdir] [--iters N] \\
        [--grad_threshold 1e-4] [--pilot] [--device cuda]

Arguments after `--` go to the trainer unchanged (e.g. a densification
schedule for a short run on the CPU).

`nan_hunt` and `nan_replay` are the counterparts of `scripts/nan_hunt.py` and
`scripts/nan_replay.py`: the densification run's recipe with checks,
snapshots and a replay that dumps a faulting step's inputs, and the replay
of one such dump (of either package) on the card or the CPU.

    python -m scorp_tpu_torch.runs.nan_hunt [outdir] [--iters N] [--device cuda]
    python -m scorp_tpu_torch.runs.nan_replay <dump.npz> [--device cuda]
"""
