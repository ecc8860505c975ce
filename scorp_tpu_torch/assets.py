"""Rotation-initialization banks, port of `scorp_tpu.assets`.

The reference ships `rotation_matrices/rotations_{32,64,128}.npz`, made by
its farthest-point rotation sampler and read by the alignment stage. Here
they are generated on first use with the same algorithm (equal to the JAX
package's banks) and cached beside the requested path; nothing is
downloaded.
"""

from __future__ import annotations

import os

import numpy as np


def load_rotation_bank(directory: str = "rotation_matrices", n: int = 64) -> np.ndarray:
    path = os.path.join(directory, f"rotations_{n}.npz")
    if os.path.exists(path):
        return np.load(path)["rotations"]
    from .pipeline.graphic import get_incremental_rotation_matrices

    print(f"Rotation bank {path} not found; generating {n} rotations...")
    rotations = get_incremental_rotation_matrices(n, np.pi / 3, np.pi / 3)
    os.makedirs(directory, exist_ok=True)
    np.savez_compressed(path, rotations=rotations)
    return rotations
