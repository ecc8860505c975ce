"""Host-side camera objects with lazy ground-truth loading, port of
`scorp_tpu.scene.cameras`.

`R` is the camera-to-world rotation (W2C.T), `T` the world-to-camera
translation; ground truth (image, alpha, sensor depth, estimated depth) is
loaded lazily per access; depth PNGs are stored in millimeters and scaled
by 1e3; znear=0.01 / zfar=100. The
device-facing view is `to_torch(device)`, returning a `core.camera.Camera`
for the rasterizer, cached per resolution, field of view, pose and device,
so that the alignment stage's `scale_resolution` / `restore_resolution`
round trip finds the original device camera again. `MiniCam` is the
network viewer's camera and the novel-view paths'.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from PIL import Image

from ..core.camera import Camera as DeviceCamera
from ..core.camera import camera_from_numpy, make_camera, world_to_view


class GroundTruth(NamedTuple):
    image: np.ndarray            # [3, H, W] f32 in [0, 1]
    alpha: np.ndarray | None     # [1, H, W]
    depth_cam: np.ndarray | None # [1, H, W] meters
    depth_est: np.ndarray | None # [1, H, W] meters


def _pil_to_chw(pil: Image.Image, resolution, scale=255.0) -> np.ndarray:
    if resolution is not None:
        pil = pil.resize(resolution)
    arr = np.asarray(pil, dtype=np.float32) / scale
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def load_ground_truth(
    resolution,
    image_path: str,
    depth_cam_path: str | None = None,
    depth_est_path: str | None = None,
) -> GroundTruth:
    with Image.open(image_path) as pil:
        bands = pil.split()
        if len(bands) > 3:
            image = np.concatenate([_pil_to_chw(b, resolution) for b in bands[:3]], axis=0)
            alpha = _pil_to_chw(bands[3], resolution)
        else:
            image = _pil_to_chw(pil, resolution)
            alpha = None
    depth_cam = None
    if depth_cam_path is not None:
        with Image.open(depth_cam_path) as d:
            depth_cam = _pil_to_chw(d, resolution, scale=1e3)  # mm -> m
    depth_est = None
    if depth_est_path is not None:
        with Image.open(depth_est_path) as d:
            depth_est = _pil_to_chw(d, resolution, scale=1e3)
    return GroundTruth(np.clip(image, 0.0, 1.0), alpha, depth_cam, depth_est)


class Camera:
    # device cameras kept per host camera: the original and the alignment
    # stage's three upscaled resolutions
    DEVICE_CACHE_SIZE = 4

    def __init__(
        self,
        colmap_id,
        R: np.ndarray,
        T: np.ndarray,
        fovx: float,
        fovy: float,
        resolution: tuple[int, int],
        image_path: str,
        depth_cam_path: str | None = None,
        depth_est_path: str | None = None,
        image_name: str = "",
        uid: int = 0,
        trans=np.array([0.0, 0.0, 0.0]),
        scale: float = 1.0,
    ):
        self.uid = uid
        self.colmap_id = colmap_id
        self.R = R
        self.T = T
        self.fovx = fovx
        self.fovy = fovy
        self._fovx_orig = fovx
        self._fovy_orig = fovy
        self.image_name = image_name
        self.resolution = tuple(resolution)
        self.resolution_original = tuple(resolution)
        self.image_path = image_path
        self.depth_cam_path = depth_cam_path + ".png" if depth_cam_path else None
        self.depth_est_path = depth_est_path + ".png" if depth_est_path else None
        self.znear = 0.01
        self.zfar = 100.0
        self.trans = trans
        self.scale = scale
        self._gt: GroundTruth | None = None
        self._device_cache: dict = {}

    # the reference's property aliases
    @property
    def FoVx(self):
        return self.fovx

    @property
    def FoVy(self):
        return self.fovy

    @property
    def image_width(self):
        return self.resolution[0]

    @property
    def image_height(self):
        return self.resolution[1]

    def gt(self, release: bool = True) -> GroundTruth:
        """Lazy GT: load at the ORIGINAL resolution."""
        gt = self._gt
        if gt is None:
            gt = load_ground_truth(
                self.resolution_original, self.image_path,
                self.depth_cam_path, self.depth_est_path,
            )
        self._gt = None if release else gt
        return gt

    def to_torch(self, device: str | torch.device = "cuda") -> DeviceCamera:
        key = (self.resolution, self.fovx, self.fovy, self.R.tobytes(),
               self.T.tobytes(), str(device))
        cam = self._device_cache.get(key)
        if cam is None:
            cam = make_camera(
                self.R, self.T, self.fovx, self.fovy,
                self.resolution[0], self.resolution[1],
                znear=self.znear, zfar=self.zfar, trans=self.trans, scale=self.scale,
                device=device,
            )
            if len(self._device_cache) >= self.DEVICE_CACHE_SIZE:
                self._device_cache.pop(next(iter(self._device_cache)))
            self._device_cache[key] = cam
        return cam

    # the alignment stage's mutation APIs
    def modify_extrinsics(self, R_c2w: np.ndarray, T_w2c: np.ndarray):
        self.R = R_c2w
        self.T = T_w2c

    def scale_resolution(self, s: float):
        self.resolution = (int(self.resolution[0] * s), int(self.resolution[1] * s))

    def restore_resolution(self):
        self.resolution = self.resolution_original

    def scale_fov(self, sx: float, sy: float):
        self.fovx = self.fovx * sx
        self.fovy = self.fovy * sy

    def restore_fov(self):
        self.fovx = self._fovx_orig
        self.fovy = self._fovy_orig

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(world_to_view(self.R, self.T, self.trans, self.scale))[:3, 3]

    @property
    def world_view_transform(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale).T


class MiniCam:
    """Viewer camera (the network GUI's contract, reference cameras.py:
    172-193): resolution, fields of view, clip planes and the transposed
    view and full-projection matrices as the viewer sends them."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform: np.ndarray, full_proj_transform: np.ndarray):
        self.image_width = width
        self.image_height = height
        self.fovy = fovy
        self.fovx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = world_view_transform
        self.full_proj_transform = full_proj_transform
        self.camera_center = np.linalg.inv(world_view_transform)[3, :3]

    def to_torch(self, device: str | torch.device = "cuda") -> DeviceCamera:
        """The rasterizer's camera on `device`, as `Camera.to_torch` builds it."""
        return camera_from_numpy(self.world_view_transform, self.full_proj_transform,
                                 self.fovx, self.fovy, self.image_width, self.image_height,
                                 self.camera_center, device=device)
