"""Quaternion / rotation-matrix math, torch port of `scorp_tpu.core.quat`.

Quaternions are (w, x, y, z) and need not be pre-normalized (normalization
happens inside, as in the original 3DGS `build_rotation`). `rotmat_to_quat`
keeps the reference's numerically stable branch choice (pytorch3d style):
the candidate of the largest squared component, denominators floored at 0.1.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) quaternion -> [..., 3, 3] rotation matrix.

    The norm clamp sits INSIDE the sqrt: sqrt's derivative at exactly 0 is
    inf, so an all-zero quaternion (a dead padded row of GaussianState) would
    turn a zero gradient into NaN (0 * inf). With the clamp inside, the
    gradient of such a row is exactly 0 and the rotation is the identity.
    Real quaternions (norm ~ 1) are bit-unaffected.
    """
    norm = torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), 1e-24))
    q = q / norm
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 4] (w,x,y,z) unit quaternion.

    Builds the four candidate quaternions from the diagonal and keeps the
    one whose squared component is largest (the first on ties, as
    `jnp.argmax`), so the sign matches the JAX package's."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp_min(q_abs2, 0.0))
    quat_by_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    quat_by_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1)
    quat_by_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1)
    quat_by_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1)
    candidates = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], dim=-2)
    # the floor avoids a division by 0 in the branches that are not taken
    candidates = candidates / (2.0 * torch.clamp_min(q_abs, 0.1))[..., :, None]
    best = torch.argmax(q_abs2, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    quat = torch.gather(candidates, -2, idx)[..., 0, :]
    return quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of (w,x,y,z) quaternions, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s): [...,3] scales + [...,4] quats -> [...,3,3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, scaling_modifier: float, q: torch.Tensor
) -> torch.Tensor:
    """Upper-triangular [..., 6] 3D covariance (xx, xy, xz, yy, yz, zz) of
    Σ = L Lᵀ with L = R diag(s·mod), the reference's
    `build_covariance_from_scaling_rotation`."""
    L = build_scaling_rotation(scaling * scaling_modifier, q)
    cov = L @ L.transpose(-1, -2)
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )
