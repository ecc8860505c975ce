"""Pluggable pairwise feature matching, port of `scorp_tpu.pipeline.matching`.

The reference matches with MASt3R (ViT inference + reciprocal nearest
neighbours). Behind the narrow interface `match(imgA, imgB) -> (uv0, uv1)`
this port has:

  * "precomputed": loads matches from .npz files on disk;
  * "sift": OpenCV's SIFT and cross-checked brute-force matching, computed
    in PyTorch on the alignment's device without cv2 (pipeline/sift.py);
  * "orb": OpenCV's ORB and cross-checked Hamming matching, computed in
    PyTorch on the alignment's device without cv2 (pipeline/orb.py);
  * "mast3r": not ported; it needs the MASt3R checkpoint, which the
    repository does not ship, and raises naming it.

The backends replicate the reference's post-processing: a 3px border filter,
a uniform subsample to n_points_per_cam, coordinates rescaled to the
original resolutions.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..device import resolve_device
from .orb import match_orb
from .sift import match_sift, to_gray


def _postprocess(uv0, uv1, shape0, shape1, size0, size1, n_points: int):
    """Border filter + uniform subsample + rescale to original coords."""
    h0, w0 = shape0
    h1, w1 = shape1
    valid = (
        (uv0[:, 0] >= 3) & (uv0[:, 0] < w0 - 3) & (uv0[:, 1] >= 3) & (uv0[:, 1] < h0 - 3)
        & (uv1[:, 0] >= 3) & (uv1[:, 0] < w1 - 3) & (uv1[:, 1] >= 3) & (uv1[:, 1] < h1 - 3)
    )
    uv0, uv1 = uv0[valid], uv1[valid]
    num = uv0.shape[0]
    n_viz = min(n_points, num)
    if num == 0:
        return uv0.astype(int), uv1.astype(int)
    idx = np.round(np.linspace(0, num - 1, n_viz)).astype(int)
    uv0, uv1 = uv0[idx], uv1[idx]
    uv0 = (uv0 / np.array([[w0, h0]]) * np.array([size0])).astype(int)
    uv1 = (uv1 / np.array([[w1, h1]]) * np.array([size1])).astype(int)
    return uv0, uv1


class _ClassicalMatcher:
    """A classical backend in PyTorch on `device`: grey images, the
    cross-checked matches of `_match`, then the shared post-processing."""

    def __init__(self, n_features: int = 4096, device: str | torch.device = "cuda"):
        self.n_features = n_features
        self.device = resolve_device(device)

    def __call__(self, image1: Image.Image, image2: Image.Image,
                 n_points_per_cam: int = 100, **_):
        a1, a2 = to_gray(image1), to_gray(image2)
        uv0, uv1, _ = self._match(a1, a2)
        if len(uv0) == 0:
            return np.zeros((0, 2), int), np.zeros((0, 2), int)
        return _postprocess(
            uv0.cpu().numpy().astype(np.float64), uv1.cpu().numpy().astype(np.float64),
            a1.shape, a2.shape, image1.size, image2.size, n_points_per_cam
        )


class SIFTMatcher(_ClassicalMatcher):
    """The "sift" backend: the JAX package's cv2 SIFT (4096 features) with
    cross-checked L2 matching, in PyTorch on `device` (pipeline/sift.py)."""

    def _match(self, a1, a2):
        return match_sift(a1, a2, self.n_features, device=self.device)


class ORBMatcher(_ClassicalMatcher):
    """The "orb" backend: the JAX package's cv2 ORB (4096 features) with
    cross-checked Hamming matching, in PyTorch on `device` (pipeline/orb.py)."""

    def _match(self, a1, a2):
        return match_orb(a1, a2, self.n_features, device=self.device)


class PrecomputedMatcher:
    """Loads (uv0, uv1) pairs from {dir}/{key}.npz with arrays uv0/uv1."""

    def __init__(self, directory: str):
        self.directory = directory

    def __call__(self, image1, image2, n_points_per_cam: int = 100, key: str = "", **_):
        path = os.path.join(self.directory, f"{key}.npz")
        if not os.path.exists(path):
            return np.zeros((0, 2), int), np.zeros((0, 2), int)
        data = np.load(path)
        uv0, uv1 = data["uv0"], data["uv1"]
        n = min(n_points_per_cam, len(uv0))
        idx = np.round(np.linspace(0, len(uv0) - 1, n)).astype(int) if len(uv0) else []
        return uv0[idx].astype(int), uv1[idx].astype(int)


class MASt3RMatcher:
    """The MASt3R backend: not ported. It needs the checkpoint below, which
    the repository does not ship; making one raises, naming it."""

    CKPT = "checkpoints/mast3r/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth"

    def __init__(self, checkpoint: str | None = None, **_):
        path = checkpoint or self.CKPT
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"the mast3r matcher needs the MASt3R checkpoint {path}, which is not "
                "present; use --matcher sift, orb or precomputed")
        raise NotImplementedError(
            f"the mast3r matcher (checkpoint {path}) is not ported to scorp_tpu_torch "
            "yet; use --matcher sift, orb or precomputed")


def get_matcher(backend: str = "auto", device: str | torch.device = "cuda", **kwargs):
    """Factory: auto prefers MASt3R when its checkpoint exists, else SIFT.
    `device` goes to the backends that compute on one (sift, orb, mast3r)."""
    if backend == "auto":
        backend = "mast3r" if os.path.exists(MASt3RMatcher.CKPT) else "sift"
    if backend == "mast3r":
        return MASt3RMatcher(device=device, **kwargs)
    if backend == "sift":
        return SIFTMatcher(device=device, **kwargs)
    if backend == "precomputed":
        return PrecomputedMatcher(**kwargs)
    return ORBMatcher(device=device, **kwargs)
