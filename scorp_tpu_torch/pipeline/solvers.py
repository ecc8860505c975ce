"""Pose/scale solvers for 9-DoF proxy alignment, port of
`scorp_tpu.pipeline.solvers` (the reference's `utils/solution.py`).

  * Kabsch / Umeyama / generalized (per-axis-scale) Umeyama / polar 12-DoF:
    closed-form SVD solvers in numpy (tiny problems, not on the hot path).
  * RANSAC: all hypotheses at once on the device, a batched 3-point
    Umeyama ([M,3,3] SVD) and the residuals of all N points as one [M,N]
    matrix; the best hypothesis's inliers are refit in numpy. Hypotheses
    are drawn by a `torch.Generator` seeded with `seed` (the JAX package
    draws with `jax.random`, which torch cannot reproduce), with the same
    rule: each hypothesis takes the top 3 of N uniform scores.
  * Adam solvers: a loop of autograd steps on the device with no host
    synchronisation and a manual torch-parity Adam (the JAX package's
    `fori_loop`); 9-DoF = quaternion + orthogonal-frame quaternion +
    sigmoid-bounded per-axis scale in [scale_min, scale_max], with the
    reference's scale and rotation regularizers.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ..core.quat import quat_to_rotmat, rotmat_to_quat
from ..device import resolve_device


# ---------------------------------------------------------------- closed form
def kabsch_np(P: np.ndarray, Q: np.ndarray):
    """Optimal R, t minimizing ||R P + t - Q||; returns (R, t, 1.0)."""
    if P.size == 0 or Q.size == 0:
        raise ValueError("Empty matrices sent to kabsch")
    cp, cq = P.mean(axis=0), Q.mean(axis=0)
    H = (P - cp).T @ (Q - cq)
    U, _, VT = np.linalg.svd(H)
    R = (U @ VT).T
    if np.linalg.det(R) < 0:
        VT[2, :] *= -1
        R = (U @ VT).T
    return R, cq - R @ cp, 1.0


def umeyama_np(source: np.ndarray, target: np.ndarray):
    """Similarity transform (R, t, scalar s)."""
    if len(source) != len(target):
        raise ValueError("Source and target points must have the same length")
    cs, ct = source.mean(axis=0), target.mean(axis=0)
    src, tgt = source - cs, target - ct
    cov = src.T @ tgt
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[-1, -1] = -1
    R = Vt.T @ D @ U.T
    s = np.sum(S * np.diag(D)) / np.sum(src**2)
    t = ct - s * (R @ cs)
    return R, t, s


def umeyama_generalized_np(source: np.ndarray, target: np.ndarray):
    """Per-axis scale variant: returns (R, t, scale[3])."""
    cs, ct = source.mean(axis=0), target.mean(axis=0)
    B = source - cs
    A = target - ct
    K = (A.T @ B) @ np.linalg.inv(B.T @ B)
    U, _, Vh = np.linalg.svd(K)
    D = np.eye(3)
    if np.linalg.det(U @ Vh) < 0:
        D[-1, -1] = -1
    R = U @ D @ Vh
    scale = np.array([
        np.trace(A @ R @ np.diag(e) @ B.T) / np.trace(B @ np.diag(e) @ B.T)
        for e in np.eye(3)
    ])
    t = ct - R @ (scale * cs)
    return R, t, scale


def polar_12dof_np(source: np.ndarray, target: np.ndarray):
    """Polar decomposition A ≈ R·R'ᵀ·S·R'·B: returns (R, t, S diag-matrix, R')."""
    cs, ct = source.mean(axis=0), target.mean(axis=0)
    B = source - cs
    A = target - ct
    H = A.T @ B @ np.linalg.pinv(B.T @ B)
    M = H.T @ H
    w, V = np.linalg.eigh(M)
    w = np.clip(w, 0.0, None)
    sqrt_M = V @ np.diag(np.sqrt(w)) @ V.T

    R = H @ np.linalg.inv(sqrt_M)
    Ur, _, Vr = np.linalg.svd(R)
    R = Ur @ Vr
    if np.linalg.det(R) < 0:
        Ur[:, -1] *= -1
        R = Ur @ Vr

    wu, Vu = np.linalg.eigh(sqrt_M)
    wu = np.clip(wu, 1e-9, None)
    R_prime = Vu.T
    if np.linalg.det(R_prime) < 0:
        Vu[:, -1] *= -1
        R_prime = Vu.T
    S = np.diag(wu)
    t = ct - R @ R_prime.T @ S @ R_prime @ cs
    return R, t, S, R_prime


def compute_residuals(source, target, R, t, s=1.0):
    transformed = (R @ (s * source).T).T + t
    return np.linalg.norm(transformed - target, axis=1)


# ---------------------------------------------------------------------- RANSAC
def _ransac_hypotheses(source, target, seed: int, max_iterations: int):
    """Batched 3-point Umeyama hypotheses + inlier residuals on the points'
    device. Returns (residuals [M, N], R [M,3,3], t [M,3], s [M])."""
    n = source.shape[0]
    gen = torch.Generator(device=source.device).manual_seed(seed)
    # 3 distinct indices per hypothesis: the top 3 of random scores
    scores = torch.rand((max_iterations, n), generator=gen, device=source.device)
    idx = torch.topk(scores, 3, dim=1).indices                 # [M, 3]
    sp, tp = source[idx], target[idx]                          # [M, 3, 3]

    cs = sp.mean(dim=1, keepdim=True)
    ct = tp.mean(dim=1, keepdim=True)
    src, tgt = sp - cs, tp - ct
    cov = torch.einsum("mni,mnj->mij", src, tgt)
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)], dim=-1)
    R = torch.einsum("mji,mj,mjk->mik", Vt, d, U.transpose(1, 2))  # V D Uᵀ
    denom = torch.clamp_min(torch.sum(src ** 2, dim=(1, 2)), 1e-12)
    s = torch.sum(S * d, dim=1) / denom
    t = ct[:, 0] - s[:, None] * torch.einsum("mij,mj->mi", R, cs[:, 0])

    # residuals of all N points for all M hypotheses
    transformed = s[:, None, None] * torch.einsum("mij,nj->mni", R, source) + t[:, None, :]
    residuals = torch.linalg.vector_norm(transformed - target[None], dim=-1)
    return residuals, R, t, s


def pc_align_ransac(
    source_points: np.ndarray,
    target_points: np.ndarray,
    threshold: float = 0.5,
    max_iterations: int = 2000,
    min_inlier_ratio: float = -1.0,
    method: Literal["umeyama", "kabsch", "umeyama_gen"] = "umeyama",
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Vectorized RANSAC on `device`; final refit on the best hypothesis's
    inliers (the first hypothesis of the largest count)."""
    if len(source_points) != len(target_points):
        raise ValueError("Source and target points must have the same length")
    if len(source_points) < 3:
        raise ValueError("At least 3 points are required to solve Umeyama.")
    del min_inlier_ratio  # early exit is pointless when all hypotheses batch
    dev = resolve_device(device)

    src = torch.as_tensor(np.asarray(source_points, np.float32), device=dev)
    tgt = torch.as_tensor(np.asarray(target_points, np.float32), device=dev)
    residuals, _, _, _ = _ransac_hypotheses(src, tgt, seed, max_iterations)
    inliers = residuals < threshold                        # [M, N]
    counts = inliers.sum(dim=1)
    best = torch.argmax(counts)
    best_mask = inliers[best].cpu().numpy()
    n_best = int(best_mask.sum())
    if n_best < 3:
        raise ValueError("No inliers found in RANSAC.")

    solve = {
        "umeyama": umeyama_np,
        "kabsch": kabsch_np,
        "umeyama_gen": umeyama_generalized_np,
    }[method]
    best_R, best_t, best_s = solve(
        np.asarray(source_points)[best_mask], np.asarray(target_points)[best_mask]
    )
    print(f"RANSAC finished with {n_best} inliers.")
    return best_R, best_t, best_s


# ------------------------------------------------------------------- Adam 9dof
def _adam(params: torch.Tensor, loss_fn, iterations: int, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """`iterations` Adam steps on one flat parameter vector (the JAX
    package's `_adam_step`, bias corrections in f32); no host sync."""
    p = params.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for i in range(iterations):
        step = np.float32(i + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** step)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** step)
        with torch.enable_grad():
            q = p.requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(q), q)
        p = p.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return p


def _trace_angle2(R: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp((torch.trace(R) - 1) / 2, -1, 1)) ** 2


def _sigmoid_scale(s, scale_min: float, scale_max: float):
    return scale_min + (scale_max - scale_min) * torch.sigmoid(s)


def adam_algorithm_3d3d_9dof(
    source_points, target_points, iterations: int = 1000, verbose_interval: int = 100,
    lr: float = 1e-3, lambda_reg_scale: float = 2e-5, lambda_reg_rot: float = 1e-4,
    scale_max: float = 1.5, scale_min: float = 0.75, init_scale=1.0,
    device: str | torch.device = "cuda", **_,
):
    """9-DoF fit of target ≈ R R2ᵀ diag(s) R2 source + t by Adam on
    `device`; returns numpy (R, t, s, R2)."""
    dev = resolve_device(device)
    init_scale = np.asarray([init_scale] * 3 if np.isscalar(init_scale) else init_scale,
                            np.float32)
    if init_scale.min() < scale_min or init_scale.max() > scale_max:
        init_scale = np.full(3, scale_min + (scale_max - scale_min) / 2, np.float32)
    init_param = np.log(
        (init_scale - scale_min) / (scale_max - scale_min)
        / (1 - (init_scale - scale_min) / (scale_max - scale_min))
    ).astype(np.float32)
    source = torch.as_tensor(np.asarray(source_points, np.float32), device=dev)
    target = torch.as_tensor(np.asarray(target_points, np.float32), device=dev)
    # one flat vector: t [0:3], q [3:7], q_orth [7:11], s [11:14] (the
    # reference optimizes q_orth too, with the same lr)
    p0 = np.concatenate([[0.01, 0.01, 0.01], [0.9, 0.01, 0.01, 0.01], [1.0, 0.0, 0.0, 0.0],
                         init_param]).astype(np.float32)

    def loss_fn(p):
        t, q, q_orth, s = p[0:3], p[3:7], p[7:11], p[11:14]
        scale = _sigmoid_scale(s, scale_min, scale_max)
        R = quat_to_rotmat(q)
        R2 = quat_to_rotmat(q_orth)
        pred = (R @ R2.T @ (scale[:, None] * (R2 @ source.T))).T + t
        loss_opt = torch.mean((pred - target) ** 2)
        reg_scale_mean = torch.mean((scale - scale.mean()) ** 2)
        reg_scale = torch.mean((s - 1.0) ** 2)
        return (loss_opt + lambda_reg_scale * (reg_scale + reg_scale_mean)
                + lambda_reg_rot * _trace_angle2(R))

    p = _adam(torch.as_tensor(p0, device=dev), loss_fn, iterations, lr)
    scale = _sigmoid_scale(p[11:14], scale_min, scale_max)
    return (quat_to_rotmat(p[3:7]).cpu().numpy(), p[0:3].cpu().numpy(),
            scale.cpu().numpy(), quat_to_rotmat(p[7:11]).cpu().numpy())


def _scale_logit(init_scale, scale_min, scale_max, allow_fix=True):
    init_scale = np.asarray([init_scale] * 3 if np.isscalar(init_scale) else init_scale,
                            np.float32)
    if allow_fix and (init_scale.min() < scale_min or init_scale.max() > scale_max):
        init_scale = np.full(3, scale_min + (scale_max - scale_min) / 2, np.float32)
    frac = (init_scale - scale_min) / (scale_max - scale_min)
    return np.log(frac / (1 - frac)).astype(np.float32)


def _adam_3d2d(
    ninedof, source_points_3d_world, target_points_2d_image, extrinsic_matrix,
    intrinsic_matrix, iterations=1000, verbose_interval=100, lr=6e-3,
    lambda_reg_rot=1e-5, scale_max=1.5, scale_min=0.75,
    init_rotation=None, init_translation=None, init_scale=1.0, seed=0,
    device: str | torch.device = "cuda", **_,
):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if init_rotation is not None:
        q0 = rotmat_to_quat(torch.as_tensor(np.asarray(init_rotation, np.float32))).numpy()
    else:
        q0 = rng.standard_normal(4).astype(np.float32)
    if init_translation is not None:
        t0 = np.asarray(init_translation, np.float32)
        t0 = np.concatenate([t0, np.zeros(max(0, 4 - t0.shape[0]), np.float32)])[:4]
    else:
        t0 = rng.standard_normal(4).astype(np.float32)
    s0 = _scale_logit(init_scale, scale_min, scale_max, allow_fix=ninedof)
    if not ninedof:
        s0 = s0[:1] * np.ones(1, np.float32) if s0.ndim else s0
    ns = s0.shape[0]
    source = torch.as_tensor(np.asarray(source_points_3d_world, np.float32), device=dev)
    target2d = torch.as_tensor(np.asarray(target_points_2d_image, np.float32), device=dev)
    w2c = torch.as_tensor(np.asarray(extrinsic_matrix, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(intrinsic_matrix, np.float32), device=dev)
    # one flat vector: t [0:4], q [4:8], s [8:8+ns], q_orth [8+ns:12+ns]
    parts = [t0, q0, s0] + ([np.array([1.0, 0.0, 0.0, 0.0], np.float32)] if ninedof else [])
    p0 = np.concatenate(parts).astype(np.float32)

    def loss_fn(p):
        t, q, s = p[0:4], p[4:8], p[8:8 + ns]
        scale = _sigmoid_scale(s, scale_min, scale_max)
        R = quat_to_rotmat(q)
        if ninedof:
            R2 = quat_to_rotmat(p[8 + ns:12 + ns])
            world = ((scale * (source @ R2.T)) @ R2) @ R.T + t[:3]
        else:
            world = (scale * source) @ R.T + t[:3]
        camp = world @ w2c[:3, :3].T + w2c[:3, 3]
        img = (camp @ K.T) / camp[:, 2:3]
        loss_opt = torch.mean((img[:, :2] - target2d) ** 2)
        return loss_opt + lambda_reg_rot * _trace_angle2(R)

    p = _adam(torch.as_tensor(p0, device=dev), loss_fn, iterations, lr)
    s = _sigmoid_scale(p[8:8 + ns], scale_min, scale_max).cpu().numpy()
    R = quat_to_rotmat(p[4:8]).cpu().numpy()
    return R, p[0:4].cpu().numpy(), s if ninedof else float(s.reshape(-1)[0])


def adam_algorithm_3d2d_9dof(*args, **kwargs):
    return _adam_3d2d(True, *args, **kwargs)


def adam_algorithm_3d2d_7dof(*args, **kwargs):
    return _adam_3d2d(False, *args, **kwargs)
