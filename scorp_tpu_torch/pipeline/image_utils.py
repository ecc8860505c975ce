"""Image crop/restore/visualization helpers (host-side PIL and numpy), a
copy of `scorp_tpu.pipeline.image_utils`.

The reference's `utils/image.py`: alpha-bbox crop with a symmetric border
and zero padding to a multiple of dfactor (`crop_with_alpha`; its xxyy is in
the original image's coordinates, border included), coordinate restoration,
and the side-by-side feature-match visualization.
"""

from __future__ import annotations

import colorsys

import numpy as np
from PIL import Image, ImageDraw


def crop_with_alpha(
    rgb: np.ndarray,
    alpha: np.ndarray,
    depth: np.ndarray | None = None,
    border: int = 800,
    dfactor: int = 8,
):
    """Crop [3,H,W] rgb (+optional [1,H,W] depth) to the alpha>0 bbox, pad a
    symmetric border (x=border, y=border//2), then zero-pad to multiples of
    dfactor. Returns (rgb', depth', (x_min, x_max, y_min, y_max))."""
    h, w = rgb.shape[1], rgb.shape[2]
    mask = np.squeeze(alpha) > 0
    if not mask.any():
        print("No alpha > 0 found in the input alpha map.")
        return rgb, depth, (0, w, 0, h)
    if border < 0:
        return rgb, depth, (0, w, 0, h)

    ys, xs = np.nonzero(mask)
    y_min, y_max = ys.min(), ys.max() + 1
    x_min, x_max = xs.min(), xs.max() + 1

    rgb_c = rgb[:, y_min:y_max, x_min:x_max]
    depth_c = depth[:, y_min:y_max, x_min:x_max] if depth is not None else None

    bx, by = border, border // 2
    pad = ((0, 0), (by, by), (bx, bx))
    rgb_p = np.pad(rgb_c, pad)
    depth_p = np.pad(depth_c, pad) if depth_c is not None else None

    h_pad, w_pad = rgb_p.shape[1], rgb_p.shape[2]
    extra_w = (-w_pad) % dfactor
    extra_h = (-h_pad) % dfactor
    pad2 = ((0, 0), (0, extra_h), (0, extra_w))
    rgb_p = np.pad(rgb_p, pad2)
    depth_p = np.pad(depth_p, pad2) if depth_p is not None else None

    xxyy = (
        int(x_min - bx),
        int(x_max + bx + extra_w),
        int(y_min - by),
        int(y_max + by + extra_h),
    )
    return rgb_p, depth_p, xxyy


def restore_coords(coords: np.ndarray, xxyy) -> np.ndarray:
    """Map (u, v) coords from cropped space back to the original image."""
    x_min, _, y_min, _ = xxyy
    return coords + np.array([[x_min, y_min]])


def show_feature_matches(
    coords1, coords2, image1: Image.Image, image2: Image.Image, save_path: str,
    x_size: int = 5, line_width: int = 2,
):
    """Side-by-side match visualization with hue-coded lines and X markers."""
    if len(coords1) != len(coords2):
        raise ValueError("The lengths of coords1 and coords2 must be the same")
    n_viz = len(coords1)

    w1, h1 = image1.size
    w2, h2 = image2.size
    image1.save(save_path.replace(".png", "_image1.png"))
    image2.save(save_path.replace(".png", "_image2.png"))

    sx = w1 / w2 if w2 else 1
    sy = h1 / h2 if h2 else 1
    img2r = image2.resize((w1, h1))

    canvas = Image.new("RGBA", (2 * w1, h1), (0, 0, 0, 0))
    canvas.paste(image1.convert("RGBA"), (0, 0))
    canvas.paste(img2r.convert("RGBA"), (w1, 0))
    draw = ImageDraw.Draw(canvas)

    for i in range(n_viz):
        (x1, y1), (x2, y2) = coords1[i], coords2[i]
        x1i, y1i = int(round(x1)), int(round(y1))
        x2i = int(round(x2 * sx + w1))
        y2i = int(round(y2 * sy))
        hue = i / (n_viz - 1) if n_viz > 1 else 0
        color = tuple(int(c * 255) for c in colorsys.hsv_to_rgb(hue, 1, 1)) + (255,)
        draw.line([(x1i, y1i), (x2i, y2i)], fill=color, width=line_width)
        for (cx, cy) in ((x1i, y1i), (x2i, y2i)):
            draw.line([(cx - x_size, cy - x_size), (cx + x_size, cy + x_size)],
                      fill=color, width=line_width)
            draw.line([(cx - x_size, cy + x_size), (cx + x_size, cy - x_size)],
                      fill=color, width=line_width)

    arr = np.array(canvas)
    black = (arr[..., 0] == 0) & (arr[..., 1] == 0) & (arr[..., 2] == 0)
    arr[black, 3] = 0
    Image.fromarray(arr, mode="RGBA").save(save_path)
