"""Image-processing ops: interpolation, gradients, blur, colormaps, port of
`scorp_tpu.ops.image_ops`.

The reference's remaining image_utils surface: bilinear grid interpolation,
Sobel gradients, 3x3 Gaussian blur, min-max depth normalisation,
gradient-magnitude maps, the turbo colormap, and the viewer's
render_net_image channel selector. Plain torch on the tensors' device
(`generate_grid` takes a `device`, cuda unless told otherwise).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device


def generate_grid(x_low, x_high, x_num, y_low, y_high, y_num,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    dev = resolve_device(device)
    xs = torch.linspace(x_low, x_high, x_num, device=dev)
    ys = torch.linspace(y_low, y_high, y_num, device=dev)
    xv, yv = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([xv.flatten(), yv.flatten()]).T


def interpolate(data: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [..., H, W] at [N, 2] coords in [0, 1]."""
    h, w = data.shape[-2], data.shape[-1]
    pos = xy * torch.tensor([w, h], dtype=torch.float32, device=xy.device)
    idx = pos.to(torch.int32)
    lerp = pos - idx.to(torch.float32)
    x0 = idx[:, 0].clamp(0, w - 1).long()
    y0 = idx[:, 1].clamp(0, h - 1).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    lx, ly = lerp[:, 0], lerp[:, 1]
    return (
        data[..., y0, x0] * (1 - lx) * (1 - ly)
        + data[..., y0, x1] * lx * (1 - ly)
        + data[..., y1, x0] * (1 - lx) * ly
        + data[..., y1, x1] * lx * ly
    )


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, 1, H, W]."""
    return (0.299 * image[:, 0] + 0.587 * image[:, 1] + 0.114 * image[:, 2])[:, None]


def _conv2d_same(image: torch.Tensor, kernel: torch.Tensor, replicate: bool = False):
    """Depthwise conv with SAME semantics; [B, C, H, W] x [kh, kw]."""
    c = image.shape[1]
    kh, kw = kernel.shape
    if replicate:
        image = F.pad(image, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
        pad = 0
    else:
        pad = (kh // 2, kw // 2)
    k = kernel.to(image)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(image, k, padding=pad, groups=c)


SOBEL_X = torch.tensor([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]])
SOBEL_Y = torch.tensor([[-1.0, -2, -1], [0, 0, 0], [1, 2, 1]])


def compute_gradient(image: torch.Tensor, rgb2gray: bool = False):
    """Sobel gradients of [B, 1or3, H, W] (replicate padding, /3 scaling)."""
    if image.ndim != 4:
        raise ValueError(f"compute_gradient takes [B, C, H, W], got {tuple(image.shape)}")
    if image.shape[1] == 3:
        if not rgb2gray:
            raise ValueError("RGB image must be converted to grayscale first")
        image = rgb_to_gray(image)
    gx = _conv2d_same(image, SOBEL_X, replicate=True) / 3.0
    gy = _conv2d_same(image, SOBEL_Y, replicate=True) / 3.0
    return gx, gy


def blur(image: torch.Tensor) -> torch.Tensor:
    """3x3 Gaussian blur; accepts [H, W] or [B, C, H, W]."""
    if image.ndim == 2:
        image = image[None, None]
    kernel = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32) / 16.0
    return _conv2d_same(image, kernel)


def gradient_map(image: torch.Tensor) -> torch.Tensor:
    """Sobel gradient-magnitude map of [C, H, W] -> [1, H, W]."""
    gx = _conv2d_same(image[:, None], SOBEL_X / 4.0)
    gy = _conv2d_same(image[:, None], SOBEL_Y / 4.0)
    mag = torch.sqrt(gx**2 + gy**2)[:, 0]
    return torch.linalg.vector_norm(mag, dim=0, keepdim=True)


def depth_normalize(depth: torch.Tensor) -> torch.Tensor:
    mn = depth.min().detach()
    mx = depth.max().detach()
    return (depth - mn) / (mx - mn)


# 16-stop turbo colormap approximation
_TURBO_STOPS = torch.tensor([
    [0.190, 0.072, 0.232], [0.276, 0.333, 0.855], [0.271, 0.565, 0.996],
    [0.151, 0.776, 0.877], [0.100, 0.905, 0.635], [0.267, 0.970, 0.393],
    [0.535, 0.996, 0.220], [0.766, 0.935, 0.189], [0.925, 0.807, 0.228],
    [0.993, 0.637, 0.199], [0.977, 0.438, 0.110], [0.881, 0.259, 0.042],
    [0.729, 0.123, 0.012], [0.550, 0.040, 0.003], [0.378, 0.010, 0.002],
    [0.480, 0.016, 0.011],
])


def colormap(map_: torch.Tensor) -> torch.Tensor:
    """[1, H, W] or [H, W] scalar map -> [3, H, W] turbo-coloured image."""
    m = map_.squeeze()
    m = (m - m.min()) / torch.clamp_min(m.max() - m.min(), 1e-12)
    stops = _TURBO_STOPS.to(m)
    t = m * (len(stops) - 1)
    i0 = t.to(torch.int32).clamp(0, len(stops) - 2).long()
    frac = t - i0.to(t.dtype)
    c = stops[i0] * (1 - frac[..., None]) + stops[i0 + 1] * frac[..., None]
    return c.permute(2, 0, 1)


def render_net_image(render_pkg: dict, render_items: list[str], render_mode: int, camera):
    """Viewer channel selector (reference gs2dgs/utils/image_utils.py:41-61)."""
    output = render_items[render_mode].lower()
    if output == "alpha":
        net_image = render_pkg["render_alpha"]
    elif output == "normal":
        net_image = (render_pkg["render_normal"] + 1) / 2
    elif output == "depth":
        net_image = render_pkg["render_depth"]
    elif output == "edge":
        net_image = gradient_map(render_pkg["render"])
    elif output == "curvature":
        net_image = gradient_map((render_pkg["render_normal"] + 1) / 2)
    else:
        net_image = render_pkg["render"]
    if net_image.shape[0] == 1:
        net_image = colormap(net_image)
    return net_image
