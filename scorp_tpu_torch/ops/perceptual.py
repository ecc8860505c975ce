"""Perceptual image distance: LPIPS-VGG and a self-contained proxy, port of
`scorp_tpu.ops.perceptual`.

1. `lpips`: the LPIPS-VGG metric (Zhang et al. 2018): VGG-16 features at
   relu{1_2,2_2,3_3,4_3,5_3}, channel-unit-normalised, squared difference,
   learned 1x1 linear heads, spatial mean, summed over layers. The weights
   are loaded from a file the user supplies (`load_lpips_weights`): an .npz
   in this layout or a torch state_dict of torchvision VGG-16 `features.*`
   with the `lpips` package's `lin*.model.1.weight` heads. None ship with
   the repository; `default_lpips_weights_path` looks where the JAX package
   looks, so one file serves both.
2. `lpips_proxy`: a deterministic stand-in, an LPIPS-shaped distance over a
   pyramid of random (seeded, fixed) 3x3 convolution features with
   per-channel unit normalisation. Useful for relative comparisons of
   renders of one scene; its scale is not calibrated LPIPS, and reports
   label it `lpips_proxy`.

Both run on the images' device with torch's convolution and pooling calls
(plain convolutions: the JAX package computes them with `lax.conv`, outside
any Pallas kernel). `lpips` runs in f32 (the package turns TF32 off);
`lpips_proxy` runs in float64, so that its value does not depend on the
device (see its docstring).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

_LEVELS = 4
_CHANNELS = (16, 32, 64, 64)


@functools.lru_cache(maxsize=1)
def _filters():
    """Fixed random 3x3 conv banks, seeded: identical on every run and to the
    JAX package's."""
    rng = np.random.default_rng(1234)
    banks = []
    cin = 3
    for cout in _CHANNELS:
        w = rng.normal(0, 1, size=(cout, cin, 3, 3)).astype(np.float32)
        w -= w.mean(axis=(1, 2, 3), keepdims=True)
        w /= np.sqrt((w**2).sum(axis=(1, 2, 3), keepdims=True))
        banks.append(w)
        cin = cout
    return tuple(banks)


def _unit_normalize(f, eps=1e-10):
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + eps)


def lpips_proxy(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between two [3, H, W] images in [0, 1] on their
    device: 0 for identical images, growing with structural difference.
    Computed in float64, returned as float32: the banks are zero-mean, so on
    a flat region each feature is ~0 plus the convolution's rounding, which
    the unit normalisation scales up; in f32 that rounding moves the result
    by ~0.5% on images with flat areas, and differently on each device and
    summation order (the JAX package's f32 value included)."""
    x = img1[None].to(torch.float64) * 2.0 - 1.0
    y = img2[None].to(torch.float64) * 2.0 - 1.0
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for w in _filters():
        w = torch.as_tensor(w, dtype=torch.float64, device=x.device)
        x = F.leaky_relu(F.conv2d(x, w, padding=1), 0.2)
        y = F.leaky_relu(F.conv2d(y, w, padding=1), 0.2)
        d = _unit_normalize(x) - _unit_normalize(y)
        total = total + (d * d).sum(dim=1).mean()
        # stride-2 average pool between levels
        x = F.avg_pool2d(x, 2)
        y = F.avg_pool2d(y, 2)
    return (total / _LEVELS).to(torch.float32)


# ---------------------------------------------------------------------------
# LPIPS (VGG-16 backbone, learned linear heads), weights loaded from disk.
# The `lpips` package's LPIPS(net='vgg'): torchvision VGG-16 config-D
# features, taps after the ReLU of conv{1_2,2_2,3_3,4_3,5_3}.
# ---------------------------------------------------------------------------

# (out_channels, in_channels) of VGG-16's 13 convs
_VGG_CHANNELS = [
    (64, 3), (64, 64),
    (128, 64), (128, 128),
    (256, 128), (256, 256), (256, 256),
    (512, 256), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512),
]
_VGG_POOL_BEFORE = {2, 4, 7, 10}       # maxpool precedes these conv indices
_VGG_TAPS = (1, 3, 6, 9, 12)           # conv indices whose ReLU output is tapped
_LPIPS_TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision `features.{idx}` indices of the 13 convs
_TORCHVISION_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# the lpips package's input ScalingLayer constants
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def convert_torch_lpips(state: dict) -> dict:
    """Our weight dict (numpy f32) from a torch-style state_dict mapping:
    torchvision VGG-16 naming (`features.{i}.weight/bias`, possibly under a
    `net.` prefix) merged with the `lpips` package's linear heads
    (`lin{j}.model.1.weight`, or `lins.{j}.` naming). Values may be torch
    tensors or numpy arrays."""
    def to_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    flat = {k.removeprefix("net."): v for k, v in state.items()}
    out = {}
    for i, tv_idx in enumerate(_TORCHVISION_CONV_IDX):
        for suffix, name in (("weight", f"conv{i}_w"), ("bias", f"conv{i}_b")):
            key = f"features.{tv_idx}.{suffix}"
            if key not in flat:
                raise KeyError(f"LPIPS weight file missing {key}")
            out[name] = to_np(flat[key])
    for j in range(5):
        for key in (f"lin{j}.model.1.weight", f"lins.{j}.model.1.weight", f"lin{j}.weight"):
            if key in flat:
                out[f"lin{j}"] = to_np(flat[key]).reshape(-1)
                break
        else:
            raise KeyError(f"LPIPS weight file missing lin{j}")
    _check_lpips_shapes(out)
    return out


def _check_lpips_shapes(w: dict):
    for i, (cout, cin) in enumerate(_VGG_CHANNELS):
        if w[f"conv{i}_w"].shape != (cout, cin, 3, 3) or w[f"conv{i}_b"].shape != (cout,):
            raise ValueError(f"conv{i} shapes {w[f'conv{i}_w'].shape}, "
                             f"{w[f'conv{i}_b'].shape} != {(cout, cin, 3, 3)}, {(cout,)}")
    for j, c in enumerate(_LPIPS_TAP_CHANNELS):
        if w[f"lin{j}"].shape != (c,):
            raise ValueError(f"lin{j} shape {w[f'lin{j}'].shape} != ({c},)")


def load_lpips_weights(path: str) -> dict:
    """LPIPS-VGG weights (numpy f32) from `.npz` (keys conv{i}_w/conv{i}_b for
    the 13 VGG convs in OIHW and lin0..lin4 per-channel head weights) or a
    torch checkpoint (`.pt`/`.pth` state_dict, see `convert_torch_lpips`)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            w = {k: np.asarray(z[k], np.float32) for k in z.files}
        if "lin0" not in w or "conv0_w" not in w:
            raise KeyError("npz missing conv{i}_w/lin{j} keys")
        w = {k: (v.reshape(-1) if k.startswith("lin") else v) for k, v in w.items()}
        _check_lpips_shapes(w)
        return w
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state:
        state = state["state_dict"]
    return convert_torch_lpips(state)


def default_lpips_weights_path() -> str | None:
    """Weight-file discovery, the JAX package's: $SCORP_LPIPS_WEIGHTS, else
    ~/.cache/scorp_tpu/lpips_vgg.npz if present."""
    env = os.environ.get("SCORP_LPIPS_WEIGHTS")
    if env:
        return env
    cached = os.path.expanduser("~/.cache/scorp_tpu/lpips_vgg.npz")
    return cached if os.path.exists(cached) else None


def lpips_weights_to(weights: dict, device: str | torch.device) -> dict:
    """The weight dict as f32 tensors on `device` (do it once per device)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in weights.items()}


def _vgg_taps(img: torch.Tensor, w: dict) -> list[torch.Tensor]:
    shift = torch.as_tensor(_LPIPS_SHIFT, device=img.device)[None, :, None, None]
    scale = torch.as_tensor(_LPIPS_SCALE, device=img.device)[None, :, None, None]
    h = (img - shift) / scale
    taps = []
    for i in range(len(_VGG_CHANNELS)):
        if i in _VGG_POOL_BEFORE:
            h = F.max_pool2d(h, 2)
        h = F.relu(F.conv2d(h, w[f"conv{i}_w"], w[f"conv{i}_b"], padding=1))
        if i in _VGG_TAPS:
            taps.append(h)
    return taps


def lpips(img0: torch.Tensor, img1: torch.Tensor, weights: dict) -> torch.Tensor:
    """LPIPS-VGG distance between two [3, H, W] images in [0, 1] on their
    device. `weights` from `load_lpips_weights` (numpy, moved here on each
    call) or `lpips_weights_to` (tensors on the images' device). The
    `lpips` package's LPIPS(net='vgg') graph: scaling layer, VGG-16 taps,
    unit normalisation, 1x1 linear heads, spatial mean, layer sum."""
    dev = img0.device
    w = {k: v if isinstance(v, torch.Tensor) and v.device == dev
         else torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in weights.items()}
    x = (img0[None] * 2.0 - 1.0).to(torch.float32)
    y = (img1[None] * 2.0 - 1.0).to(torch.float32)
    total = torch.zeros((), device=dev)
    for j, (fx, fy) in enumerate(zip(_vgg_taps(x, w), _vgg_taps(y, w))):
        d = _unit_normalize(fx) - _unit_normalize(fy)
        total = total + (w[f"lin{j}"][None, :, None, None] * d * d).sum(dim=1).mean()
    return total
