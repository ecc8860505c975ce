"""Quaternion/matrix conversions on numpy arrays (the reference's
`utils/geometry.py` names; the implementations live in `core/quat.py`), port
of `scorp_tpu.pipeline.geometry`."""

from __future__ import annotations

import numpy as np
import torch

from ..core.quat import quat_to_rotmat, rotmat_to_quat


def quaternion_to_matrix_np(q: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def matrix_to_quaternion_np(m: np.ndarray) -> np.ndarray:
    return rotmat_to_quat(torch.as_tensor(np.asarray(m, np.float32))).numpy()


# tensor-native aliases (the reference's *_tensor variants)
quaternion_to_matrix = quat_to_rotmat
matrix_to_quaternion = rotmat_to_quat
