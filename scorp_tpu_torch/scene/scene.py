"""Scene container: dataset detection, camera lists, Gaussian loading.

Port of `scorp_tpu.scene.scene` (host-side only), with the behavioral
contract of the original 3DGS `Scene`: dataset type detection (COLMAP
`sparse/` -> Colmap, `transforms_full.json` -> ToyDesk; Blender split files
unsupported), first-run artifacts (`input.ply` copy + `cameras.json`),
seeded camera shuffling, `cameras_extent` from the nerf++ radius,
per-resolution-scale camera lists, and the Gaussian load paths (checkpoint
iteration / pretrained PLY list), and `save` of a trained PLY per iteration.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from ..core.plyio import GaussianData, load_gaussian_ply, save_gaussian_ply
from .cameras import Camera
from .dataset_readers import (
    SceneInfo,
    camera_to_json,
    load_camera,
    read_colmap_scene,
    read_toydesk_scene,
)


def search_max_iteration(folder: str) -> int:
    return max(int(name.split("_")[-1]) for name in os.listdir(folder))


class Scene:
    def __init__(
        self,
        args,
        load_iteration: int | None = None,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        pretrained_ply_path_list: list[str] | None = None,
        max_sh_degree: int = 3,
        load_gaussians: bool = True,
        rng: random.Random | None = None,
    ):
        """`rng` shuffles the camera lists (default: the global `random`,
        as the reference does)."""
        self.model_path = args.model_path
        self.loaded_iter = None
        self.gaussians: GaussianData | None = None
        self.gaussian_sizes: list[int] | None = None  # per-file sizes for multi-ply loads

        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(self.model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        src = args.source_path
        if os.path.exists(os.path.join(src, "sparse")):
            info = read_colmap_scene(src, args.images, args.eval, args.split_yml_name)
        elif os.path.exists(os.path.join(src, "transforms_train.json")):
            raise NotImplementedError("Blender datasets are not supported for this pipeline")
        elif os.path.exists(os.path.join(src, "transforms_full.json")):
            info = read_toydesk_scene(src, args.images, args.eval, split_yml_name=args.split_yml_name)
        else:
            raise ValueError(f"Could not recognize scene type at {src}")
        self.scene_info: SceneInfo = info

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            with open(info.ply_path, "rb") as fsrc, open(
                os.path.join(self.model_path, "input.ply"), "wb"
            ) as fdst:
                fdst.write(fsrc.read())
            cams_json = [
                camera_to_json(i, c)
                for i, c in enumerate(list(info.test_cameras) + list(info.train_cameras))
            ]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            shuffler = rng if rng is not None else random
            shuffler.shuffle(train_infos)
            shuffler.shuffle(test_infos)

        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(args, i, c, scale) for i, c in enumerate(train_infos)
            ]
            self.test_cameras[scale] = [
                load_camera(args, i, c, scale) for i, c in enumerate(test_infos)
            ]

        self.init_points = np.asarray(info.points, np.float32)
        self.init_colors = np.asarray(info.colors, np.float32)
        if not load_gaussians:
            return
        if self.loaded_iter:
            self.gaussians = load_gaussian_ply(
                os.path.join(
                    self.model_path, "point_cloud",
                    f"iteration_{self.loaded_iter}", "point_cloud.ply",
                ),
                max_sh_degree=max_sh_degree,
            )
        elif pretrained_ply_path_list is not None:
            parts = [load_gaussian_ply(p, max_sh_degree=max_sh_degree)
                     for p in pretrained_ply_path_list]
            self.gaussian_sizes = [p.n for p in parts]
            g = parts[0]
            for p in parts[1:]:
                g = g.concat(p)
            self.gaussians = g

    def save(self, iteration: int, gaussians: GaussianData | None = None):
        g = gaussians if gaussians is not None else self.gaussians
        path = os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")
        save_gaussian_ply(os.path.join(path, "point_cloud.ply"), g)

    def get_train_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.test_cameras[scale]
