"""Plain camera matrices of a pose (the 3DGS conventions: COLMAP axes,
znear 0.01, zfar 100), computed from the benchmark's own poses."""

from __future__ import annotations

import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


def camera(pose: dict, width: int, height: int, device) -> dict:
    """view [4, 4] world->camera, full [4, 4] world->clip, the centre and the
    tangents of the half fields of view, as float32 tensors."""
    w2c = np.eye(4)
    w2c[:3, :3] = pose["R"].T
    w2c[:3, 3] = pose["T"]
    tx, ty = math.tan(pose["fovx"] / 2), math.tan(pose["fovy"] / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = 1.0 / ty
    proj[3, 2] = 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return dict(view=f32(w2c), full=f32(proj @ w2c), center=f32(np.linalg.inv(w2c)[:3, 3]),
                tanx=f32(tx), tany=f32(ty), width=int(width), height=int(height))
