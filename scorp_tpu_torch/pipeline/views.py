"""View-selection scoring and helpers, port of `scorp_tpu.pipeline.views`
(host-side numpy and scipy, without cv2).

The reference's `utils/views.py`: greedy selection of high-quality,
mask-complete, viewpoint-diverse object crops feeding proxy generation.

Scoring:
  * image quality = 0.3·Laplacian-variance sharpness + 0.7·mask ratio;
  * mask ratio = fraction of alpha==255 pixels; images below the 0.3
    quantile are discarded;
  * mask completeness = contour area / convex-hull area;
  * greedy objective = 0.25·quality + 0.5·mask + 0.4·completeness +
    0.25·diversity, diversity = 0.5·min-max-normalized closest-camera
    distance + 0.5·z-axis angle difference;
  * selected crops are alpha-bbox cropped and upscaled 2x until
    >= 10000 px.

The JAX package computes the grey image, the Laplacian and the contours
with cv2; the port does not depend on cv2 and reproduces each
of those values exactly (tests/test_torch_pipeline_utils.py holds them
equal to cv2's):
  * `cv2.cvtColor(RGBA2GRAY)` on uint8: cv2's fixed-point weights,
    (R·9798 + G·19235 + B·3735 + 2^14) >> 15 (equal to cv2 5.0's on all
    2^24 RGB triples);
  * `cv2.Laplacian(CV_64F)`: the kernel [[0,1,0],[1,-4,1],[0,1,0]] with
    BORDER_REFLECT_101 (numpy's "reflect" padding), exact in float64;
  * `findContours(RETR_EXTERNAL)` + `contourArea`: the shoelace area of the
    outer border of every 8-connected component that is not inside a hole
    of another (4-connected background), traced through the pixel centres
    by Suzuki-Abe border following on a zero-padded image (a single pixel
    has area 0, a filled w x h box (w-1)(h-1));
  * `contourArea(convexHull(...))`: the area of the convex hull of the
    foreground pixel centres (0 for collinear sets).
All the areas are half-integers summed exactly in float64, so the ratios
equal cv2's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image
from scipy import ndimage
from scipy.spatial.distance import cdist

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg")

# the 8-neighbourhood as cv2's contour tracer orders it: counterclockwise on
# screen (y down) from east, as (dy, dx)
_DIRS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))


def rgba_to_gray(rgba: np.ndarray) -> np.ndarray:
    """[H,W,>=3] uint8 -> [H,W] uint8, as cv2.cvtColor(COLOR_RGBA2GRAY)."""
    r, g, b = (rgba[..., c].astype(np.int32) for c in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def laplacian(gray: np.ndarray) -> np.ndarray:
    """[H,W] -> [H,W] float64, as cv2.Laplacian(gray, cv2.CV_64F) (ksize 1,
    BORDER_REFLECT_101)."""
    p = np.pad(gray.astype(np.float64), 1, mode="reflect")
    return p[:-2, 1:-1] + p[1:-1, :-2] - 4.0 * p[1:-1, 1:-1] + p[1:-1, 2:] + p[2:, 1:-1]


def _trace_outer_border(f: np.ndarray, y0: int, x0: int) -> np.ndarray:
    """[M,2] (x, y) points of the outer border that starts at (y0, x0), the
    first pixel of its component in raster order, traced as cv2 does
    (Suzuki-Abe): the first neighbour clockwise from the west, then each
    next border pixel counterclockwise from the previous one; ends on the
    step from the first neighbour back to the start. `f` is zero-padded."""
    s = 4
    while True:
        s = (s - 1) & 7
        y1, x1 = y0 + _DIRS[s][0], x0 + _DIRS[s][1]
        if f[y1, x1] or s == 4:
            break
    if not f[y1, x1]:
        return np.array([[x0, y0]], np.int64)  # an isolated pixel
    pts = []
    y3, x3 = y0, x0
    while True:
        for k in range(1, 9):
            d = (s + k) & 7
            y4, x4 = y3 + _DIRS[d][0], x3 + _DIRS[d][1]
            if f[y4, x4]:
                break
        pts.append((x3, y3))
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            break
        y3, x3, s = y4, x4, (d + 4) & 7
    return np.asarray(pts, np.int64)


def _shoelace_area(pts: np.ndarray) -> float:
    """|polygon area| of integer points, exact (as cv2.contourArea)."""
    x, y = pts[:, 0], pts[:, 1]
    twice = int(np.sum(np.roll(x, 1) * y - np.roll(y, 1) * x))
    return abs(twice) * 0.5


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull vertices of integer points (Andrew's monotone chain, exact
    integer cross products; collinear points give a degenerate hull)."""
    pts = sorted(set(map(tuple, pts.tolist())))
    if len(pts) <= 2:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def external_contours(mask: np.ndarray) -> list[np.ndarray]:
    """The outer borders cv2.findContours(RETR_EXTERNAL) finds in a binary
    mask, each as [M,2] (x, y) pixel points (every border pixel, i.e.
    CHAIN_APPROX_NONE), in raster order of their first pixel."""
    f = np.pad(np.asarray(mask, bool), 1)
    fg, _ = ndimage.label(f, structure=np.ones((3, 3), bool))   # 8-connected
    bg, _ = ndimage.label(~f)                                    # 4-connected
    outside = bg == bg[0, 0]
    near = np.zeros_like(f)
    near[1:] |= outside[:-1]
    near[:-1] |= outside[1:]
    near[:, 1:] |= outside[:, :-1]
    near[:, :-1] |= outside[:, 1:]
    external = set(np.unique(fg[near & f]).tolist())
    labels, first = np.unique(fg.ravel(), return_index=True)
    width = f.shape[1]
    out = []
    for lab, idx in sorted(zip(labels.tolist(), first.tolist()), key=lambda p: p[1]):
        if lab == 0 or lab not in external:
            continue
        y0, x0 = divmod(idx, width)
        out.append(_trace_outer_border(f, y0, x0) - 1)  # undo the padding
    return out


def get_xyxy_from_mask(mask: np.ndarray):
    """Bounding box (x1, y1, x2, y2) of the nonzero region of a mask."""
    if mask.sum() == 0:
        raise ValueError("No non-zero pixels found in the mask.")
    ys, xs = np.where(mask > 0)
    return (xs.min(), ys.min(), xs.max(), ys.max())


def post_process_rgba_imgs(rgba_imgs: list[np.ndarray]) -> list[Image.Image]:
    """Crop each RGBA image to its alpha bbox; upscale 2x until >= 10000 px."""
    out = []
    for rgba in rgba_imgs:
        rgba = np.asarray(rgba)
        left, top, right, bottom = get_xyxy_from_mask(rgba[:, :, 3])
        crop = Image.fromarray(rgba[top : bottom + 1, left : right + 1, :])
        while crop.size[0] * crop.size[1] < 10000:
            crop = crop.resize((crop.size[0] * 2, crop.size[1] * 2))
        out.append(crop)
    return out


def evaluate_mask_ratio(rgba_img: np.ndarray) -> float:
    alpha = rgba_img[:, :, 3]
    return np.count_nonzero(alpha == 255) / alpha.size


def evaluate_mask_shape_quality(alpha: np.ndarray) -> float:
    """Contour-area / convex-hull-area compactness of the mask."""
    contours = external_contours(alpha == 255)
    if not contours:
        return 0.0
    area = sum(_shoelace_area(c) for c in contours)
    # every foreground pixel lies inside an external border, so the hull of
    # the borders is the hull of the foreground
    hull_area = _shoelace_area(_convex_hull(np.vstack(contours)))
    if hull_area == 0:
        return 0.0
    return area / hull_area


def calculate_image_quality(rgba_img: np.ndarray) -> float:
    sharpness = laplacian(rgba_to_gray(rgba_img)).var()
    return 0.3 * sharpness + 0.7 * evaluate_mask_ratio(rgba_img)


def camera_centers(t_w2c: np.ndarray, r_w2c: np.ndarray) -> np.ndarray:
    """[N,3] camera centers from W2C poses: -(Rᵀ t)."""
    return -(t_w2c[:, :, None] * r_w2c).sum(axis=1)


def viewpoint_diversity_score(t_w2c, r_w2c, current_idx, used_indices) -> float:
    """Min-max-normalized position distance + raw z-axis angle difference."""
    if not used_indices:
        return 1.0
    t_c2w = camera_centers(t_w2c, r_w2c)

    all_pos = cdist([t_c2w[current_idx]], t_c2w)[0]
    pos_raw = np.min(all_pos[used_indices])
    pos_min, pos_max = np.min(all_pos), np.max(all_pos)
    pos_score = (pos_raw - pos_min) / (pos_max - pos_min + 1e-8)

    current_z = r_w2c[current_idx][:, 2]
    all_z = r_w2c[:, :, 2]
    all_z = all_z / np.linalg.norm(all_z, axis=1)[:, None]
    current_z = current_z / np.linalg.norm(current_z)
    dot_used = np.dot(all_z, current_z)[used_indices]
    angle_score = np.min(1.0 - np.abs(dot_used))

    return 0.5 * pos_score + 0.5 * angle_score


def select_views(
    rgba_dir: str,
    image_names: list[str],
    img_num: int,
    t_w2c: np.ndarray,
    r_w2c: np.ndarray,
    quality_weight: float = 0.25,
    mask_weight: float = 0.5,
    diversity_weight: float = 0.25,
    completeness_weight: float = 0.4,
    mask_threshold: float = 0.3,
) -> tuple[list[int], list[np.ndarray]]:
    """Greedy quality/coverage/diversity view selection.

    Returns (selected indices, selected RGBA arrays).
    """
    rgba_imgs, quality, mask_scores, completeness = [], [], [], []
    for name in image_names:
        img = np.array(Image.open(os.path.join(rgba_dir, f"{name}.png")))
        rgba_imgs.append(img)
        quality.append(calculate_image_quality(img))
        mask_scores.append(evaluate_mask_ratio(img))
        completeness.append(evaluate_mask_shape_quality(img[:, :, 3]))

    quality = np.asarray(quality, np.float64)
    mask_scores = np.asarray(mask_scores, np.float64)
    quality = (quality - quality.min()) / max(quality.max() - quality.min(), 1e-12)
    mask_scores = (mask_scores - mask_scores.min()) / max(
        mask_scores.max() - mask_scores.min(), 1e-12
    )
    # drop low-coverage views (quantile threshold)
    mask_scores[mask_scores < np.quantile(mask_scores, mask_threshold)] = 0.0

    selected: list[int] = []
    remaining = {i for i in range(len(rgba_imgs)) if mask_scores[i] > 0}

    while len(selected) < img_num and remaining:
        best_score, best_idx = -np.inf, -1
        for idx in remaining:
            base = (
                quality_weight * quality[idx]
                + mask_weight * mask_scores[idx]
                + completeness_weight * completeness[idx]
            )
            div = viewpoint_diversity_score(t_w2c, r_w2c, idx, selected)
            total = base + diversity_weight * div
            if total > best_score:
                best_score, best_idx = total, idx
        selected.append(best_idx)
        remaining.remove(best_idx)

    return selected, [rgba_imgs[i] for i in selected]


def merge_to_rgba(rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[H,W,3] u8 + [H,W] bool -> [H,W,4] u8 with mask as alpha."""
    alpha = (mask > 0).astype(np.uint8) * 255
    return np.dstack([rgb, alpha])


def parse_colmap_poses(colmap_path: str):
    """COLMAP extrinsics -> (t_w2c [N,3], q_w2c [N,4], image names), sorted
    by name (the reference's standalone parsers)."""
    from ..core import colmap as colmap_io

    if colmap_path.endswith(".bin"):
        images = colmap_io.read_extrinsics_binary(colmap_path)
    else:
        images = colmap_io.read_extrinsics_text(colmap_path)
    entries = sorted(images.values(), key=lambda im: im.name)
    t = np.stack([im.tvec for im in entries])
    q = np.stack([im.qvec for im in entries])
    names = [os.path.splitext(im.name)[0] for im in entries]
    return t, q, names


def parse_transforms_poses(path: str, is_opengl: bool = False):
    """transforms json -> (t_c2w, R_c2w, image names)."""
    import json

    with open(path) as f:
        contents = json.load(f)
    t_list, r_list, names = [], [], []
    for frame in contents["frames"]:
        name = os.path.splitext(os.path.basename(frame["file_path"]))[0]
        transform = np.array(frame["transform_matrix"])
        if is_opengl:
            transform[:3, 1:3] *= -1
        r_list.append(transform[:3, :3])
        t_list.append(transform[:3, 3])
        names.append(name)
    return np.array(t_list), np.array(r_list), names


def select_views_from_colmap(rgba_dir: str, colmap_path: str, img_num: int,
                             quality_weight=0.25, mask_weight=0.25,
                             diversity_weight=0.25) -> list[np.ndarray]:
    """Standalone entry: poses straight from a COLMAP file."""
    import torch

    from ..core.quat import quat_to_rotmat

    t_w2c, q_w2c, names = parse_colmap_poses(colmap_path)
    r_w2c = quat_to_rotmat(torch.as_tensor(q_w2c, dtype=torch.float32)).numpy()
    _, imgs = select_views(
        rgba_dir, names, img_num, t_w2c, r_w2c,
        quality_weight=quality_weight, mask_weight=mask_weight,
        diversity_weight=diversity_weight,
    )
    return imgs


def merge_to_rgba_dirs(img_dir: str, mask_dir: str, output_dir: str):
    """Merge RGB frames with single-channel binary masks into RGBA files."""
    masks = sorted(f for f in os.listdir(mask_dir)
                   if os.path.splitext(f)[1] in IMG_EXTENSIONS)
    rgbs = sorted(f for f in os.listdir(img_dir)
                  if os.path.splitext(f)[1] in IMG_EXTENSIONS)
    os.makedirs(output_dir, exist_ok=True)
    for mask_name, rgb_name in zip(masks, rgbs):
        with Image.open(os.path.join(mask_dir, mask_name)) as m:
            mask = np.asarray(m)
        with Image.open(os.path.join(img_dir, rgb_name)) as im:
            rgb = np.asarray(im.convert("RGB"))
        Image.fromarray(merge_to_rgba(rgb, mask)).save(os.path.join(output_dir, rgb_name))


def main(argv=None):
    """Standalone view-selection CLI."""
    import argparse

    parser = argparse.ArgumentParser(description="select viewpoints")
    parser.add_argument("--rgba_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="")
    parser.add_argument("--colmap_path", type=str, default="")
    parser.add_argument("--img_num", type=int, default=4)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if not os.path.exists(args.rgba_dir):
        raise ValueError(f"RGBA directory {args.rgba_dir} does not exist")
    selected = select_views_from_colmap(args.rgba_dir, args.colmap_path, args.img_num)
    crops = post_process_rgba_imgs(selected)
    for i, crop in enumerate(crops):
        crop.save(os.path.join(args.output_dir, f"img_{i}.png"))
    print(f"Saved {len(crops)} images to {args.output_dir}")


if __name__ == "__main__":
    main()
