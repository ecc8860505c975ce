"""View selection for proxy generation, port of
`scorp_tpu.apps.view_selection` (the reference's `view_selection.py` CLI):
per segmented object, greedily pick `img_num` high-quality diverse RGBA
views, prune undersized crops (<25% of the median area), crop/upscale, and
write model_path/masked_image_rgba_selected/<obj>/img_i.png. Host-side
(numpy, scipy, PIL; no cv2).

    python -m scorp_tpu_torch.apps.view_selection -s <scene> -m <model> [--device cuda]
"""

from __future__ import annotations

import os
import shutil
from argparse import ArgumentParser

import numpy as np
import yaml

from ..config import ModelParams, PipelineParams, get_combined_args
from ..device import resolve_device
from ..pipeline.views import post_process_rgba_imgs, select_views
from ..scene import Scene


def view_select(dataset: ModelParams):
    description_path = os.path.join(dataset.source_path, "description.yml")
    if not os.path.exists(description_path):
        raise FileNotFoundError(f"Config file not found at {description_path}")
    with open(description_path) as f:
        description = yaml.safe_load(f)
    selected_img_num = description.get("img_num", 3)

    rgba_path = os.path.join(dataset.source_path, "masked_image_rgba")
    if not os.path.exists(rgba_path):
        raise FileNotFoundError(f"RGBA path not found at {rgba_path}")
    rgba_selected_path = os.path.join(dataset.model_path, "masked_image_rgba_selected")
    if os.path.exists(rgba_selected_path):
        shutil.rmtree(rgba_selected_path)
    os.makedirs(rgba_selected_path)

    scene = Scene(dataset, shuffle=False, load_gaussians=False)
    train_cams = scene.get_train_cameras()
    print(f"Number of train cameras: {len(train_cams)}")

    r_w2c = np.array([cam.R.T for cam in train_cams])
    t_w2c = np.array([cam.T for cam in train_cams])
    image_names = [cam.image_name for cam in train_cams]

    for obj in os.listdir(rgba_path):
        if obj == "masked" or not os.path.isdir(os.path.join(rgba_path, obj)):
            continue
        obj_dir = os.path.join(rgba_path, obj)
        out_dir = os.path.join(rgba_selected_path, obj)
        os.makedirs(out_dir, exist_ok=True)

        _, selected = select_views(
            obj_dir, image_names, selected_img_num, t_w2c, r_w2c,
            quality_weight=0.25, mask_weight=0.25, diversity_weight=0.25,
        )

        # prune undersized images (<25% of median area)
        sizes = [img.shape[0] * img.shape[1] for img in selected]
        median = np.median(sizes)
        for i, size in enumerate(sizes[::-1]):
            if size < median * 0.25:
                idx = len(sizes) - 1 - i
                print(f"Removing image {idx} with size {size}")
                selected.pop(idx)

        print(f"Selected {len(selected)} images for {obj}")
        crops = post_process_rgba_imgs(selected)
        for i, crop in enumerate(crops):
            crop.save(os.path.join(out_dir, f"img_{i + 1}.png"))
        print(f"Saved {len(crops)} images to {out_dir}")


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the pipeline's device (default cuda); this stage itself "
                             "runs on the host")
    args = get_combined_args(parser, argv)
    resolve_device(args.device)
    view_select(ModelParams.extract(args).finalize())


if __name__ == "__main__":
    main()
