"""Novel camera paths and frame export (2DGS tooling), port of
`scorp_tpu.pipeline.render_paths`.

PCA-normalise the training camera centres, generate a smooth ellipse
(orbit) or spiral path of viewer cameras (`MiniCam`), save u8/f32 images
and encode frames into a video. Host code: the paths are numpy, and a
camera goes to a device through `MiniCam.to_torch`.

Deliberate differences from the JAX module, which calls cv2: `save_img_u8`
writes through PIL (the JAX one converts RGB to BGR for `cv2.imwrite`; the
PNG's pixels are the same), and `create_videos` reads the PNGs with PIL and
encodes them on a device with `pipeline.video` (an intra-only MPEG-4 Part 2
`mp4v` stream in an `.mp4`, the format the JAX one asks of cv2's
VideoWriter), so nothing here needs cv2.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..core.camera import projection_matrix, world_to_view
from ..device import resolve_device
from ..scene.cameras import MiniCam
from . import video


def _pose_pca(centers: np.ndarray):
    mean = centers.mean(axis=0)
    _, _, vt = np.linalg.svd(centers - mean)
    return mean, vt  # rows: principal axes


def _minicam(eye, look_at, upv, ref) -> MiniCam:
    """A viewer camera at `eye` looking at `look_at`, with the image's down
    axis along -`upv` crossed in, at `ref`'s resolution and fields of view."""
    fwd = look_at - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    T = -R.T @ eye
    w2c = world_to_view(R, T)
    proj_m = projection_matrix(0.01, 100.0, ref.fovx, ref.fovy)
    return MiniCam(ref.resolution[0], ref.resolution[1], ref.fovy, ref.fovx, 0.01, 100.0,
                   w2c.T.astype(np.float32), (w2c.T @ proj_m.T).astype(np.float32))


def _plane(cameras):
    centers = np.stack([c.camera_center for c in cameras])
    mean, axes = _pose_pca(centers)
    u, v, _ = axes
    proj = (centers - mean) @ np.stack([u, v]).T
    return mean, axes, np.abs(proj[:, 0]).max(), np.abs(proj[:, 1]).max()


def generate_ellipse_path(cameras, n_frames: int = 120, z_offset: float = 0.0):
    """Orbit path through the PCA plane of the training camera centers."""
    mean, (u, v, w), a, b = _plane(cameras)
    look_at = mean + w * z_offset
    return [_minicam(mean + a * np.cos(t) * u + b * np.sin(t) * v, look_at, -w, cameras[0])
            for t in np.linspace(0, 2 * np.pi, n_frames, endpoint=False)]


def generate_spiral_path(cameras, n_frames: int = 120, n_rounds: int = 2,
                         height_amp: float = 0.3):
    mean, (u, v, w), a, b = _plane(cameras)
    out = []
    for i, t in enumerate(np.linspace(0, 2 * np.pi * n_rounds, n_frames)):
        hz = height_amp * np.sin(2 * np.pi * i / n_frames)
        eye = mean + a * np.cos(t) * u + b * np.sin(t) * v + hz * w
        out.append(_minicam(eye, mean, -w, cameras[0]))
    return out


# reference naming
generate_path = generate_ellipse_path


def save_img_u8(img: np.ndarray, path: str):
    """[3,H,W] or [H,W,3] float image -> u8 PNG."""
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = img.transpose(1, 2, 0)
    arr = (np.clip(np.nan_to_num(img), 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    elif arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., [2, 1, 0, 3]]  # cv2.imwrite, the JAX writer, reads 4 channels as BGRA
    Image.fromarray(arr).save(path, compress_level=1)  # cv2.imwrite's default zlib level


def save_img_f32(img: np.ndarray, path: str):
    if img.ndim == 3 and img.shape[0] in (1, 3):
        img = img.transpose(1, 2, 0)
    np.save(path if path.endswith(".npy") else path + ".npy", img.astype(np.float32))


def read_png(path: str) -> np.ndarray:
    """A PNG as [H, W, 3] uint8 RGB: grey expanded and alpha dropped, the
    pixels `cv2.imread` reads (in BGR order) in the JAX package."""
    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def create_videos(frame_dir: str, out_path: str, fps: int = 30, *,
                  device: str | torch.device = "cuda"):
    """Encode {frame_dir}/*.png, in name order, into an MPEG-4 Part 2
    (`mp4v`) `.mp4` at fps, every frame an I-VOP encoded on `device`."""
    frames = sorted(f for f in os.listdir(frame_dir) if f.endswith(".png"))
    if not frames:
        raise ValueError(f"No frames found in {frame_dir}")
    dev = resolve_device(device)
    video.write_video(out_path, (torch.from_numpy(read_png(os.path.join(frame_dir, name))).to(dev)
                                 for name in frames), fps)
    return out_path
