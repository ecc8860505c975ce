"""2D object segmentation: open-vocabulary detection on a seed frame and
video mask propagation, port of `scorp_tpu.apps.segmentation_2d` (the same
CLI and outputs).

    python -m scorp_tpu_torch.apps.segmentation_2d -s <scene> [--mask_dir <dir>]

GroundingDINO proposes the best box per prompt on the seed frame (one
combined caption or one per prompt); SAM2 propagates masklets both ways
from it; per-object RGBA images and the union "masked" RGBA are written
under <scene>/masked_image_rgba/, each mask cleaned by a 5x5-ellipse
morphological opening then closing. While the GroundingDINO/SAM2
checkpoints are absent, the offline backends run: boxes from the scene
description's `boxes:` entry and masks from `--mask_dir`.

No cv2: images are read and written with PIL (the RGBA PNGs hold the pixels
cv2 writes), and the morphology is scipy.ndimage's with cv2's element (the
5x5 ellipse is a 17-pixel cross-like mask, not a disc) and cv2's borders
(erosion sees 1 outside the image, dilation 0), which scipy's
binary_opening/binary_closing defaults do not give. Host code: no device.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import yaml
from PIL import Image, ImageOps
from scipy import ndimage

from ..pipeline.perception import (
    BoxfileDetector,
    GroundingDINODetector,
    MaskdirSegmenter,
    SAM2VideoSegmenter,
)
from ..scene.dataset_readers import read_colmap_scene

# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
ELLIPSE_5X5 = np.array([[0, 0, 1, 0, 0],
                        [1, 1, 1, 1, 1],
                        [1, 1, 1, 1, 1],
                        [1, 1, 1, 1, 1],
                        [0, 0, 1, 0, 0]], bool)


def _best_boxes(prompt_list, boxes, logits, phrases):
    """Highest-confidence box per prompt (reference segmentation_2d.py:36-53)."""
    prompts_dict = {p: i for i, p in enumerate(prompt_list)}
    best = [None] * len(prompt_list)
    best_logit = [-1.0] * len(prompt_list)
    for box, logit, phrase in zip(boxes, logits, phrases):
        if phrase not in prompts_dict:
            continue
        cls = prompts_dict[phrase]
        if best[cls] is None or float(logit) > best_logit[cls]:
            best[cls] = np.asarray(box)
            best_logit[cls] = float(logit)
    if any(b is None for b in best):
        missing = [p for p, b in zip(prompt_list, best) if b is None]
        raise ValueError(f"Detected objects do not cover all prompts: missing {missing}")
    return np.stack(best)


def _erode(m):
    return ndimage.binary_erosion(m, ELLIPSE_5X5, border_value=1)


def _dilate(m):
    return ndimage.binary_dilation(m, ELLIPSE_5X5, border_value=0)


def _clean_mask(mask: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx OPEN then CLOSE with the 5x5 ellipse, thresholded > 0."""
    m = _dilate(_erode(np.asarray(mask) > 0))
    return _erode(_dilate(m))


def _read_rgb(path: str) -> np.ndarray:
    """[H, W, 3] u8 RGB, as cv2.imread(path) reads it (EXIF orientation
    applied, alpha dropped, grey and palette images expanded)."""
    with Image.open(path) as im:
        return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))


def _write_rgba(path: str, rgb: np.ndarray, mask: np.ndarray) -> None:
    """An RGBA PNG at cv2.imwrite's default zlib level (1; PIL's is 6, which
    costs 3-5x the time for the same pixels)."""
    Image.fromarray(np.dstack([rgb, mask.astype(np.uint8) * 255])).save(path, compress_level=1)


def get_mask2d(
    prompt_list: list[str],
    data_dir: str,
    image_path_list: list[str],
    ext: str = "png",
    first_image_name: str | None = None,
    box_threshold: float = 0.35,
    text_threshold: float = 0.25,
    combine_prompt: bool = True,
    detector=None,
    segmenter=None,
):
    image_path_list = sorted(image_path_list)
    if first_image_name is None:
        first_image_id = 0
    else:
        target = first_image_name + "." + ext
        candidates = [i for i, p in enumerate(image_path_list)
                      if os.path.basename(p) == target]
        if not candidates:
            raise ValueError(f"Image {first_image_name} not found in the camera list")
        first_image_id = candidates[0]
    first_image_path = image_path_list[first_image_id]

    if detector is None:
        detector = GroundingDINODetector()
    if segmenter is None:
        segmenter = SAM2VideoSegmenter()

    # --- detect boxes on the seed frame ---
    if combine_prompt:
        caption = " . ".join(prompt_list)
        boxes, logits, phrases = detector.predict(
            first_image_path, caption, box_threshold, text_threshold
        )
    else:
        all_boxes, all_logits, all_phrases = [], [], []
        for p in prompt_list:
            b, lg, ph = detector.predict(first_image_path, p, box_threshold, text_threshold)
            all_boxes.append(b)
            all_logits.append(lg)
            all_phrases.extend(ph)
        boxes = np.concatenate(all_boxes)
        logits = np.concatenate(all_logits)
        phrases = all_phrases
    print(f"Detected objects: {sorted(set(phrases))}")
    print(f"Prompts: {prompt_list}")
    if len(prompt_list) > len(phrases):
        raise ValueError("The number of prompts is less than the number of detected objects")
    best = _best_boxes(prompt_list, boxes, logits, phrases)

    height, width = _read_rgb(first_image_path).shape[:2]
    cxcywh = best * np.array([width, height, width, height])
    xyxy = np.stack([
        cxcywh[:, 0] - cxcywh[:, 2] / 2, cxcywh[:, 1] - cxcywh[:, 3] / 2,
        cxcywh[:, 0] + cxcywh[:, 2] / 2, cxcywh[:, 1] + cxcywh[:, 3] / 2,
    ], axis=1)

    segmenter.init(image_path_list)
    for idx, box in enumerate(xyxy):
        segmenter.add_box(box.tolist(), first_image_id, idx)

    rgba_dir = os.path.join(data_dir, "masked_image_rgba")
    for prompt in prompt_list:
        os.makedirs(os.path.join(rgba_dir, prompt), exist_ok=True)
    os.makedirs(os.path.join(rgba_dir, "masked"), exist_ok=True)

    def write_frame(frame_idx, object_ids, masks):
        image_path = image_path_list[frame_idx]
        frame = _read_rgb(image_path)
        out_name = os.path.basename(image_path).rsplit(".", 1)[0] + ".png"
        union = np.zeros(frame.shape[:2], bool)
        for object_id, mask in zip(object_ids, masks):
            mask = _clean_mask(mask)
            union |= mask
            _write_rgba(os.path.join(rgba_dir, prompt_list[int(object_id)], out_name),
                        frame, mask)
        _write_rgba(os.path.join(rgba_dir, "masked", out_name), frame, union)

    for frame_idx, object_ids, masks in segmenter.propagate(first_image_id - 1, True):
        write_frame(frame_idx, object_ids, masks)
    for frame_idx, object_ids, masks in segmenter.propagate(first_image_id, False):
        write_frame(frame_idx, object_ids, masks)


def segmentation(source_path: str, mask_dir: str | None = None):
    description_path = os.path.join(source_path, "description.yml")
    if not os.path.exists(description_path):
        raise FileNotFoundError(f"Config file not found at {description_path}")
    with open(description_path) as f:
        description = yaml.safe_load(f)

    prompt_list = [p.strip() for p in description["prompts"].split(",")]
    ext = description["ext"]
    first_image_name = description.get("first_image_name")
    if "detect_conf" in description:
        box_threshold = text_threshold = description["detect_conf"]
    else:
        box_threshold = description["box_threshold"]
        text_threshold = description["text_threshold"]
    combine_prompt = description.get("combine_prompt", True)

    image_path_list = [
        info.image_path
        for info in read_colmap_scene(source_path, "images", False).train_cameras
    ]

    detector = None
    segmenter = None
    live_available = os.path.exists(GroundingDINODetector.CKPT) and os.path.exists(
        SAM2VideoSegmenter.CKPT
    )
    if not live_available:
        if mask_dir is None:
            raise RuntimeError(
                "GroundingDINO/SAM2 checkpoints not found under checkpoints/; "
                "either download them or pass --mask_dir with per-object masks"
            )
        detector = BoxfileDetector(description.get("boxes", {p: [0.5, 0.5, 1.0, 1.0]
                                                             for p in prompt_list}))
        segmenter = MaskdirSegmenter(mask_dir, prompt_list)

    get_mask2d(
        prompt_list=prompt_list, data_dir=source_path,
        image_path_list=image_path_list, ext=ext,
        first_image_name=first_image_name,
        box_threshold=box_threshold, text_threshold=text_threshold,
        combine_prompt=combine_prompt, detector=detector, segmenter=segmenter,
    )


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    parser.add_argument("-s", "--source_path", type=str, required=True)
    parser.add_argument("--mask_dir", type=str, default=None,
                        help="offline backend: directory of per-object binary masks")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    segmentation(args.source_path, args.mask_dir)


if __name__ == "__main__":
    main()
