"""Rigid/scale transforms of Gaussian clouds (host-side numpy), port of
`scorp_tpu.pipeline.gs_transform`.

On raw `GaussianData` parameters, as the reference's `utils/gaussians.py`:
  * translate: xyz += T
  * scale: xyz *= s (optionally around the centroid); log-scales shifted by
    log(s) (a per-axis multiply on the activated scales)
  * rotate: xyz @ Rᵀ (optionally around the centroid); quaternion composed
    as q_new = quat(R) * q (f32, `core.quat`); SH rest bands rotated with
    real-SH Wigner-D matrices for sh_degree 3, a no-op for degree 0,
    NotImplementedError otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.plyio import GaussianData
from ..core.quat import quat_multiply, rotmat_to_quat
from .sh_rotation import rotate_sh


def gaussians_translate(g: GaussianData, t: np.ndarray) -> GaussianData:
    g.xyz = g.xyz + np.asarray(t, g.xyz.dtype)[None]
    return g


def gaussians_scale(g: GaussianData, scale, fix_center: bool = False) -> GaussianData:
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.repeat(scale[None], 3)
    if fix_center:
        mean = g.xyz.mean(axis=0)
        g.xyz = (g.xyz - mean) * scale[None] + mean
    else:
        g.xyz = g.xyz * scale[None]
    n_axes = g.scaling.shape[1]
    g.scaling = np.log(np.exp(g.scaling) * scale[None, :n_axes]).astype(np.float32)
    return g


def gaussians_rotate(g: GaussianData, R: np.ndarray, fix_center: bool = False) -> GaussianData:
    R = np.asarray(R, np.float64)
    if fix_center:
        mean = g.xyz.mean(axis=0)
        g.xyz = ((g.xyz - mean) @ R.T + mean).astype(np.float32)
    else:
        g.xyz = (g.xyz @ R.T).astype(np.float32)

    q_r = rotmat_to_quat(torch.as_tensor(R[None].astype(np.float32)))[0]
    g.rotation = quat_multiply(q_r.expand(g.n, 4),
                               torch.as_tensor(np.asarray(g.rotation, np.float32))).numpy()

    if g.sh_degree == 0:
        return g
    if g.sh_degree == 3:
        g.f_rest = rotate_sh(g.f_rest, R).astype(np.float32)
        return g
    raise NotImplementedError(f"sh_degree={g.sh_degree} is not supported")
