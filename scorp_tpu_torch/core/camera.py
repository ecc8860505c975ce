"""Camera matrix conventions, torch port of `scorp_tpu.core.camera`.

The conventions of the original 3DGS code:

* `R` is the camera-to-world rotation (i.e. W2C.T), `T` the world-to-camera
  translation.
* `world_view_transform` is the 4x4 world-to-camera matrix **transposed**
  (row-vector convention: `p_view_hom = p_world_hom @ world_view_transform`).
* `projection_matrix` is an OpenGL-style perspective matrix with z_sign=+1
  and z mapped via zfar/(zfar-znear), also stored transposed.
* `full_proj_transform = world_view_transform @ projection_matrix`.
* `camera_center = inv(world_view_transform)[3, :3]`.

`Camera` (the counterpart of `CameraJax`) carries only what the rasterizer
needs, as f32 tensors on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0) -> np.ndarray:
    """4x4 W2C matrix; optional recentering of the camera center."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if scale != 1.0 or np.any(translate != 0.0):
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection, z_sign=+1, depth in [0, zfar/(zfar-znear)]."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass(frozen=True)
class Camera:
    """Device-side camera.

    `viewmatrix` / `projmatrix` are stored transposed (row-vector style) so
    that `p_hom @ viewmatrix` maps world -> view. The fov tangents are 0-d
    f32 tensors, so the focal lengths derived from them round as the JAX
    package's f32 scalars do.
    """

    viewmatrix: torch.Tensor  # [4, 4]  W2C^T
    projmatrix: torch.Tensor  # [4, 4]  (P @ W2C)^T = W2C^T @ P^T
    campos: torch.Tensor      # [3]
    tanfovx: torch.Tensor     # 0-d
    tanfovy: torch.Tensor     # 0-d
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.viewmatrix.device


def camera_from_numpy(viewmatrix, projmatrix, fovx: float, fovy: float,
                      width: int, height: int, campos,
                      device: str | torch.device = "cuda") -> Camera:
    """Build a `Camera` from host matrices (e.g. a `CameraJax`'s leaves
    converted with np.asarray): transposed view and full-projection
    matrices, fields of view in radians, and the camera center."""
    dev = resolve_device(device)

    def f32(a):
        # C order: a transposed matrix would otherwise keep its strides
        return torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)

    return Camera(
        viewmatrix=f32(viewmatrix),
        projmatrix=f32(projmatrix),
        campos=f32(campos),
        tanfovx=f32(math.tan(fovx * 0.5)),
        tanfovy=f32(math.tan(fovy * 0.5)),
        width=int(width),
        height=int(height),
    )


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    trans=np.array([0.0, 0.0, 0.0]),
    scale: float = 1.0,
    device: str | torch.device = "cuda",
) -> Camera:
    """Counterpart of `make_camera_jax`: C2W rotation + W2C translation."""
    w2c = world_to_view(R, T, trans, scale)
    view_t = w2c.T.astype(np.float32)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full_proj_t = (view_t @ proj.T).astype(np.float32)
    cam_center = np.linalg.inv(view_t)[3, :3].astype(np.float32)
    return camera_from_numpy(view_t, full_proj_t, fovx, fovy, width, height,
                             cam_center, device=device)


def look_at_camera(
    eye, target, up, fovx: float, fovy: float, width: int, height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """Convenience constructor for tests/synthetic scenes."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # Camera-to-world rotation with columns (right, down, forward): the GS
    # convention is +z forward, +y down in camera space.
    R = np.stack([right, down, fwd], axis=1)
    # T is the world-to-camera translation: t = -R^T @ eye.
    T = -R.T @ eye
    return make_camera(R, T, fovx, fovy, width, height, device=device)
