"""Point-to-point ICP, port of `scorp_tpu.pipeline.icp` (the reference's
open3d `registration_icp` calls in its alignment stage).

Semantics of open3d's TransformationEstimationPointToPoint (no scaling):
per iteration, each source point matches its nearest target within
`threshold`; Kabsch on the correspondence set updates the transform; an
initialization stops when fitness and inlier RMSE both change by less than
1e-6 (or nothing matches), or at max_iteration. fitness = inliers /
len(source), inlier_rmse over the matched pairs.

All initializations run as one batch [B, S, 3] on the points' device with a
per-init `done` mask, as the JAX package's `lax.map` of `while_loop`s
computes them: a converged init keeps its transform while the others go on.
The host reads the mask every `SYNC_EVERY` iterations to drop finished
inits from the batch, so host synchronisations stay bounded. The nearest
neighbour is an exact [S, T] distance matrix,
‖a‖² − 2a·b + ‖b‖² in f32 with TF32 off (`scorp_tpu_torch/__init__.py`;
TF32 would change which argmin wins), built for a chunk of inits at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

SYNC_EVERY = 10          # iterations between the host's reads of `done`
CHUNK_ELEMS = 1 << 30    # distance-matrix entries per chunk of inits (4 GiB)


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # [4, 4]
    fitness: torch.Tensor         # scalar
    inlier_rmse: torch.Tensor     # scalar


def _nearest(src_t: torch.Tensor, target: torch.Tensor):
    """For each transformed source point of each init [B, S, 3]: (nearest
    target index [B, S], distance [B, S]); the first index on ties."""
    b, s = src_t.shape[:2]
    t2 = torch.sum(target ** 2, dim=1)
    tgt_t = target.T.expand(b, 3, target.shape[0])
    chunk = max(1, CHUNK_ELEMS // (s * target.shape[0]))
    idx, dist = [], []
    for i in range(0, b, chunk):
        part = src_t[i:i + chunk]
        s2 = torch.sum(part ** 2, dim=2, keepdim=True)
        # s2 + (-2)(a·b) then + t2: the JAX package's rounding order
        d2 = torch.baddbmm(s2, part, tgt_t[:part.shape[0]], alpha=-2.0).add_(t2)
        j = torch.argmin(d2, dim=2)
        idx.append(j)
        dist.append(torch.sqrt(torch.clamp_min(torch.gather(d2, 2, j[..., None])[..., 0], 0.0)))
    return torch.cat(idx), torch.cat(dist)


def _masked_kabsch(src, dst, w):
    """Batched weighted Kabsch: R [B,3,3], t [B,3] minimizing
    Σ w ||R src + t - dst||² per init."""
    wsum = torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-8)
    cs = (w[..., None] * src).sum(dim=1) / wsum
    cd = (w[..., None] * dst).sum(dim=1) / wsum
    H = torch.einsum("bsi,bsj->bij", w[..., None] * (src - cs[:, None]), dst - cd[:, None])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(1, 2), U.transpose(1, 2)
    det = torch.linalg.det(V @ Ut)
    d = torch.ones(det.shape[0], 3, dtype=H.dtype, device=H.device)
    d[:, 2] = 1.0 - 2.0 * (det < 0).to(H.dtype)
    R = V @ (d[..., None] * Ut)
    t = cd - torch.einsum("bij,bj->bi", R, cs)
    return R, t


def _apply(T, source):
    return torch.einsum("sj,bij->bsi", source, T[:, :3, :3]) + T[:, None, :3, 3]


def _fit(dist, threshold: float):
    """(inlier weights, inlier count, fitness, inlier RMSE) per init."""
    inlier = (dist < threshold).to(torch.float32)
    n_in = inlier.sum(dim=1)
    rmse = torch.sqrt(torch.sum(inlier * dist ** 2, dim=1) / torch.clamp_min(n_in, 1.0))
    return inlier, n_in, n_in / dist.shape[1], rmse


def _icp_batch(source, target, threshold: float, inits, max_iteration: int):
    """ICP from every init [B, 4, 4] at once -> (T [B,4,4], fitness [B],
    rmse [B]) at each init's final transform."""
    T = inits.clone()
    b = T.shape[0]
    fit_prev = torch.full((b,), -1.0, device=T.device)
    rmse_prev = torch.full((b,), -1.0, device=T.device)
    done = torch.zeros(b, dtype=torch.bool, device=T.device)
    active = torch.arange(b, device=T.device)   # the inits still in the batch
    for i in range(max_iteration):
        if i % SYNC_EVERY == 0 and i > 0:
            active = active[~done[active]]       # one host read of the mask
            if active.numel() == 0:
                break
        Ta = T[active]
        src_t = _apply(Ta, source)
        idx, dist = _nearest(src_t, target)
        inlier, n_in, fitness, rmse = _fit(dist, threshold)
        R, t = _masked_kabsch(src_t, target[idx], inlier)
        T_new = torch.eye(4, device=T.device).repeat(active.numel(), 1, 1)
        T_new[:, :3, :3] = R @ Ta[:, :3, :3]
        T_new[:, :3, 3] = torch.einsum("bij,bj->bi", R, Ta[:, :3, 3]) + t
        was_done = done[active]
        converged = (((fitness - fit_prev[active]).abs() < 1e-6)
                     & ((rmse - rmse_prev[active]).abs() < 1e-6)) | (n_in < 1.0)
        T[active] = torch.where(was_done[:, None, None], Ta, T_new)
        fit_prev[active] = fitness
        rmse_prev[active] = rmse
        done[active] = was_done | converged
    _, _, fitness, rmse = _fit(_nearest(_apply(T, source), target)[1], threshold)
    return T, fitness, rmse


def registration_icp(source, target, threshold, init=None, max_iteration: int = 400,
                     device: str | torch.device = "cuda") -> ICPResult:
    dev = resolve_device(device)
    source = torch.as_tensor(np.asarray(source, np.float32), device=dev)
    target = torch.as_tensor(np.asarray(target, np.float32), device=dev)
    init = np.eye(4) if init is None else np.asarray(init)
    T, fit, rmse = _icp_batch(source, target, float(threshold),
                              torch.as_tensor(init[None], dtype=torch.float32, device=dev),
                              max_iteration)
    return ICPResult(T[0], fit[0], rmse[0])


def _subsample(points: np.ndarray, max_points: int) -> np.ndarray:
    if len(points) <= max_points:
        return points
    step = int(np.ceil(len(points) / max_points))
    return points[::step]


def best_icp_transform(
    pc_original: np.ndarray,
    pc_refined: np.ndarray,
    rotations: np.ndarray,
    threshold: float,
    max_iteration: int = 400,
    max_points: int = 8192,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Multi-init ICP (refined -> original): the bank's rotations about the
    centroids, the identity-rotation centroid shift twice and the identity
    (the reference's 67 restarts); returns the highest-fitness 4x4 (the
    first on ties).

    Both clouds are uniformly subsampled for the search, as the reference
    downsamples: the coarse init does not need full density.
    """
    if np.any(~np.isfinite(pc_original)) or np.any(~np.isfinite(pc_refined)):
        raise ValueError("Point clouds contain NaN/Inf values")
    dev = resolve_device(device)

    center_o = pc_original.mean(axis=0)
    center_r = pc_refined.mean(axis=0)
    inits = []
    for rot in rotations:
        T = np.eye(4)
        T[:3, :3] = rot
        T[:3, 3] = center_o - rot @ center_r
        inits.append(T)
    shift = np.eye(4)
    shift[:3, 3] = center_o - center_r
    inits.extend([shift, shift.copy(), np.eye(4)])
    inits = np.stack(inits).astype(np.float32)

    src = torch.as_tensor(_subsample(pc_refined, max_points), dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(_subsample(pc_original, max_points), dtype=torch.float32, device=dev)
    print(f"ICP threshold: {threshold}; {len(inits)} inits; "
          f"{src.shape[0]} source / {tgt.shape[0]} target points")
    Ts, fits, _ = _icp_batch(src, tgt, float(threshold),
                             torch.as_tensor(inits, device=dev), max_iteration)
    fits = fits.cpu().numpy()
    best = int(np.argmax(fits))
    best_T = Ts[best].cpu().numpy().astype(np.float64)
    print("Best ICP transformation:\n", best_T)
    print("Best fitness:", float(fits[best]))
    return best_T
