"""External perception adapters, port of `scorp_tpu.pipeline.perception`.

Narrow interfaces mirroring the call surfaces of the reference's
checkpoint-driven models, each with a live backend (lazy imports, gated on
checkpoint presence) and an offline one:

  * Detector.predict(image_path, caption) -> (boxes cxcywh [0,1], logits,
    phrases): GroundingDINO SwinB, or the "boxfile" backend reading boxes
    from the scene description;
  * VideoSegmenter: SAM2 video propagation, or the "maskdir" backend that
    reads per-frame binary masks from disk.

The live classes are the JAX package's, unchanged: they import their
packages and load their checkpoints on first use, and raise while those are
absent from the repository. The offline backends need no cv2:
`read_mask` decodes a mask PNG with PIL as cv2.imread(IMREAD_UNCHANGED)
decodes it, and takes the channel the JAX code takes (the last of cv2's BGR
or BGRA order).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


class GroundingDINODetector:
    CKPT = "checkpoints/GroundingDINO/groundingdino_swinb_cogcoor.pth"
    CFG = "submodules/GroundingDINO/groundingdino/config/GroundingDINO_SwinB_cfg.py"

    def __init__(self, checkpoint: str | None = None, cfg: str | None = None):
        self.checkpoint = checkpoint or self.CKPT
        self.cfg = cfg or self.CFG
        self._model = None

    def _load(self):
        if self._model is None:
            from groundingdino.util.inference import load_model  # type: ignore

            self._model = load_model(self.cfg, self.checkpoint)
        return self._model

    def predict(self, image_path: str, caption: str,
                box_threshold: float = 0.35, text_threshold: float = 0.25):
        from groundingdino.util.inference import load_image, predict  # type: ignore

        _, image_for_model = load_image(image_path)
        boxes, logits, phrases = predict(
            model=self._load(), image=image_for_model, caption=caption,
            box_threshold=box_threshold, text_threshold=text_threshold,
            remove_combined=True,
        )
        return np.asarray(boxes), np.asarray(logits), list(phrases)


class BoxfileDetector:
    """Offline detector: reads {prompt: [cx, cy, w, h] normalized} from the
    scene's description.yml `boxes:` section or a boxes.yml next to it."""

    def __init__(self, boxes: dict[str, list[float]]):
        self.boxes = boxes

    def predict(self, image_path: str, caption: str, box_threshold=0.35,
                text_threshold=0.25):
        prompts = [p.strip() for p in caption.split(".") if p.strip()]
        boxes, logits, phrases = [], [], []
        for p in prompts:
            if p in self.boxes:
                boxes.append(self.boxes[p])
                logits.append(1.0)
                phrases.append(p)
        return np.asarray(boxes, np.float32), np.asarray(logits, np.float32), phrases


class SAM2VideoSegmenter:
    CKPT = "checkpoints/sam2.1/sam2.1_hiera_large.pt"
    CFG = "configs/sam2.1/sam2.1_hiera_l.yaml"

    def __init__(self, checkpoint: str | None = None, cfg: str | None = None):
        self.checkpoint = checkpoint or self.CKPT
        self.cfg = cfg or self.CFG
        self._pred = None
        self._state = None

    def _load(self):
        if self._pred is None:
            from sam2.build_sam import build_sam2_video_predictor  # type: ignore

            self._pred = build_sam2_video_predictor(self.cfg, self.checkpoint)
        return self._pred

    def init(self, image_paths: list[str]):
        self._state = self._load().init_state(image_paths)

    def add_box(self, box_xyxy, frame_idx: int, obj_id: int):
        return self._pred.add_new_points_or_box(
            self._state, box=list(box_xyxy), frame_idx=frame_idx, obj_id=obj_id
        )

    def propagate(self, start_frame_idx: int, reverse: bool):
        """Yields (frame_idx, object_ids, masks [K,1,H,W] float>0)."""
        for frame_idx, object_ids, masks in self._pred.propagate_in_video(
            self._state, start_frame_idx=start_frame_idx, reverse=reverse
        ):
            yield frame_idx, [int(i) for i in object_ids], [
                np.asarray(m[0].cpu().numpy()) > 0 for m in masks
            ]


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_mask(path: str) -> np.ndarray:
    """The boolean mask `MaskdirSegmenter` takes from an image file: nonzero
    where cv2.imread(path, IMREAD_UNCHANGED)'s last channel is (a grey
    image's only channel, the red of a colour image, the alpha of one with
    alpha: palette PNGs are expanded to RGB, or RGBA where they carry
    transparency, and grey+alpha to alpha, as cv2 decodes them). 16-bit
    grey PNGs keep their 16 bits; 16-bit colour PNGs, which PIL narrows to
    8 bits, raise."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == _PNG_SIGNATURE and head[24] == 16 and head[25] in (2, 6):
        raise ValueError(f"{path}: a 16-bit colour PNG mask cannot be read without cv2; "
                         "save the mask as 8-bit or 16-bit grey")
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0] if arr.shape[-1] == 3 else arr[..., -1]
    return arr > 0


class MaskdirSegmenter:
    """Offline segmenter: per-object mask PNGs at
    {mask_dir}/{prompt}/{image_name}.png (nonzero = object)."""

    def __init__(self, mask_dir: str, prompts: list[str]):
        self.mask_dir = mask_dir
        self.prompts = prompts
        self.image_paths: list[str] = []

    def init(self, image_paths: list[str]):
        self.image_paths = image_paths

    def add_box(self, box_xyxy, frame_idx: int, obj_id: int):
        return None, list(range(len(self.prompts))), []

    def propagate(self, start_frame_idx: int, reverse: bool):
        indices = (
            range(start_frame_idx, -1, -1) if reverse
            else range(max(start_frame_idx, 0), len(self.image_paths))
        )
        for frame_idx in indices:
            name = os.path.basename(self.image_paths[frame_idx]).rsplit(".", 1)[0]
            masks = []
            for p in self.prompts:
                path = os.path.join(self.mask_dir, p, f"{name}.png")
                masks.append(read_mask(path) if os.path.exists(path) else None)
            if all(m is None for m in masks):
                continue
            h = next(m.shape for m in masks if m is not None)
            masks = [m if m is not None else np.zeros(h, bool) for m in masks]
            yield frame_idx, list(range(len(self.prompts))), masks
