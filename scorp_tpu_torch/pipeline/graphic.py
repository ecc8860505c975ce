"""Geometry misc: centroids, outlier filters, rotation banks, unprojection,
port of `scorp_tpu.pipeline.graphic` (host-side).

The reference's `utils/graphic.py`: convex-hull / bbox / mean centroids,
IQR/std outlier filtering, the farthest-point-sampled bank of well-spread
rotations (the generator of the shipped rotations_{32,64,128}.npz), and
pixel -> point-cloud unprojection. The bank is computed as the JAX package
computes it (f32 matrices, an einsum of the traces, clip, arccos), on the
CPU whatever the device, so that the greedy picks and the bank are equal.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

import torch

from ..core.plyio import save_point_cloud_ply
from ..core.quat import quat_to_rotmat


def _tetra_volume(v):
    m = np.vstack([v.T, np.ones(4)])
    return abs(np.linalg.det(m)) / 6.0


def _convex_hull_centroid(points: np.ndarray):
    try:
        from scipy.spatial import ConvexHull, Delaunay, QhullError
    except ImportError:
        return np.mean(points, axis=0)
    try:
        hull = ConvexHull(points)
    except QhullError:
        print("QhullError: Could not construct convex hull, possibly due to "
              "coplanar or collinear points.")
        return None
    tri = Delaunay(hull.points[hull.vertices])
    total = 0.0
    weighted = np.zeros(3)
    for simplex in tri.simplices:
        verts = hull.points[hull.vertices][simplex]
        vol = _tetra_volume(verts)
        total += vol
        weighted += vol * np.mean(verts, axis=0)
    if total == 0:
        return np.mean(points, axis=0)
    return weighted / total


def get_centroid(points: np.ndarray,
                 method: Literal["convex_hull", "bbox", "mean"] = "convex_hull"):
    if method == "convex_hull":
        return _convex_hull_centroid(points)
    if method == "bbox":
        # the reference's quirk kept: min + max/2
        return np.min(points, axis=0) + np.max(points, axis=0) / 2
    if method == "mean":
        return np.mean(points, axis=0)
    raise ValueError("Invalid method. Must be one of 'convex_hull', 'bbox', or 'mean'.")


def filter_outliers(records, method: Literal["iqr", "std", "manual"] = "iqr",
                    threshold=1.5, lower_bound=None, upper_bound=None):
    records = np.asarray(records)
    if method == "iqr":
        q1, q3 = np.percentile(records, 25), np.percentile(records, 75)
        iqr = q3 - q1
        lower_bound, upper_bound = q1 - threshold * iqr, q3 + threshold * iqr
    elif method == "std":
        mean, std = records.mean(), records.std()
        lower_bound, upper_bound = mean - threshold * std, mean + threshold * std
    elif method == "manual":
        if lower_bound is None or upper_bound is None:
            raise ValueError("For 'manual' method, both lower_bound and upper_bound "
                             "must be provided.")
    else:
        raise ValueError("Invalid method. Must be one of 'iqr', 'std', or 'manual'.")
    keep = (records >= lower_bound) & (records <= upper_bound)
    return records[keep], records[~keep], lower_bound, upper_bound


def get_incremental_rotation_matrices(
    n: int, min_angle_diff_init: float, min_angle_diff_util: float, seed: int = 2025,
) -> np.ndarray:
    """Farthest-point-sampled bank of n well-spread rotations.

    Oversamples 128n quaternion-uniform rotations, then greedily picks the
    candidate maximizing the minimum geodesic angle to the selected set.
    """
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n * 128, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    candidates = quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()

    def min_angles(existing, cand):
        traces = torch.einsum("kab,mab->km", torch.as_tensor(existing), torch.as_tensor(cand))
        angles = torch.arccos(torch.clamp((traces - 1.0) / 2.0, -1.0, 1.0))
        return angles.min(dim=0).values.numpy()

    selected = [candidates[0]]
    remaining = list(range(1, len(candidates)))
    max_min_diff = np.pi
    while len(selected) < n:
        diffs = min_angles(np.stack(selected), candidates[np.asarray(remaining)])
        best = int(np.argmax(diffs))
        max_min_diff = float(diffs[best])
        selected.append(candidates[remaining.pop(best)])
    print(f"minimum angle difference: {max_min_diff / np.pi * 180:.4f} degrees")
    return np.stack(selected)


def pix2pcd(coords, depths, fx, fy, cx, cy, save_path: str | None = None) -> np.ndarray:
    """(u, v) pixel coords [N,2] + depths [N] -> camera-space points [N,3]."""
    u, v = coords[:, 0], coords[:, 1]
    z = depths
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    points = np.stack([x, y, z], axis=-1)
    if save_path is not None:
        save_point_cloud_ply(save_path, points)
    return points


def image_depth2pcd(image: np.ndarray, depth: np.ndarray, fx, fy, cx, cy,
                    save_path: str) -> np.ndarray:
    """RGB [3,H,W] + depth [1,H,W] -> colored point cloud PLY."""
    mask = depth > 0
    v, u = np.where(np.squeeze(mask))
    coords = np.stack([u, v], axis=-1)
    points = pix2pcd(coords, depth[0, v, u], fx, fy, cx, cy)
    colors = image[:, v, u].T
    save_point_cloud_ply(save_path, points, colors)
    return points
