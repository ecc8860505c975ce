"""The fused preprocess: every field of `Preprocessed`, for every row, in one
CUDA launch (`csrc/preprocess.cu`).

`preprocess_kernel` is the wrapper, as `composite` is K2's: it launches the
kernel for CUDA tensors and runs `common.preprocess_plain`, the plain
version, for CPU tensors. The kernel has no backward, so `rasterize` (and
any caller whose outputs autograd must record) calls `preprocess_plain`
where an input requires grad, and this wrapper everywhere else.
`preprocess_kernel.launches` counts the kernel's launches.

The kernel repeats the plain version's operations in its order (built with
-fmad=false), so its outputs are bit-identical to the plain version's on
the card; the source's header says what that takes.
"""

from __future__ import annotations

import torch

from ...core.camera import Camera
from .._build import check_tensor, load
from .common import Preprocessed, preprocess_plain

REPLACES = "scorp_tpu/ops/raster/common.py:343 preprocess (no TPU kernel: XLA fuses it)"
SOURCE = "scorp_tpu_torch/csrc/preprocess.cu"
MAX_SH_DEGREE = 3


def check_inputs(means3d: torch.Tensor, opacities: torch.Tensor, cam: Camera, *,
                 shs: torch.Tensor | None, sh_degree: int, colors_precomp: torch.Tensor | None,
                 scales: torch.Tensor | None, quats: torch.Tensor | None,
                 cov3d_precomp: torch.Tensor | None, screen_deltas: torch.Tensor | None,
                 alive: torch.Tensor | None) -> None:
    """Raise unless the kernel takes these inputs: contiguous float32 on
    `means3d`'s device (`alive` bool [N]), scales [N, 3] and quats [N, 4] or
    cov3d_precomp [N, 6], and shs [N, K, 3] at an SH degree of 0-3 with
    K >= (degree + 1)^2, or colors_precomp. Inputs the call does not read
    (`shs` beside colours, scales and quats beside a covariance) are not
    checked."""
    dev = means3d.device
    n = means3d.shape[0]
    f32 = torch.float32
    check_tensor(means3d, "means3d", f32, (n, 3), dev)
    check_tensor(opacities.reshape(n), "opacities", f32, (n,), dev)
    if cov3d_precomp is not None:
        check_tensor(cov3d_precomp, "cov3d_precomp", f32, (n, 6), dev)
    elif scales is None or quats is None:
        raise ValueError("preprocess_kernel needs scales and quats, or cov3d_precomp")
    else:
        check_tensor(scales, "scales", f32, (n, 3), dev)
        check_tensor(quats, "quats", f32, (n, 4), dev)
    if colors_precomp is None:
        if shs is None or not 0 <= sh_degree <= MAX_SH_DEGREE:
            raise ValueError(f"preprocess_kernel needs shs and an SH degree of 0-"
                             f"{MAX_SH_DEGREE} (got {sh_degree}), or colors_precomp")
        bands = shs.shape[1] if shs.dim() == 3 else 0
        if bands < (sh_degree + 1) ** 2:
            raise ValueError(f"shs of shape {tuple(shs.shape)} cannot evaluate degree "
                             f"{sh_degree}")
        check_tensor(shs, "shs", f32, (n, bands, 3), dev)
    if screen_deltas is not None:
        check_tensor(screen_deltas, "screen_deltas", f32, (n, 2), dev)
    if alive is not None:
        check_tensor(alive, "alive", torch.bool, (n,), dev)
    check_tensor(cam.viewmatrix, "viewmatrix", f32, (4, 4), dev)
    check_tensor(cam.projmatrix, "projmatrix", f32, (4, 4), dev)
    check_tensor(cam.campos, "campos", f32, (3,), dev)
    check_tensor(cam.tanfovx, "tanfovx", f32, (), dev)
    check_tensor(cam.tanfovy, "tanfovy", f32, (), dev)


def preprocess_kernel(means3d: torch.Tensor, opacities: torch.Tensor, cam: Camera, *,
                      shs: torch.Tensor | None = None, sh_degree: int = 0,
                      colors_precomp: torch.Tensor | None = None,
                      scales: torch.Tensor | None = None, quats: torch.Tensor | None = None,
                      cov3d_precomp: torch.Tensor | None = None, scale_modifier: float = 1.0,
                      screen_deltas: torch.Tensor | None = None,
                      alive: torch.Tensor | None = None) -> Preprocessed:
    """`preprocess_plain`'s outputs: for CUDA tensors in one launch on the
    current stream, reading nothing back to the host, and raising on inputs
    the kernel does not take (`check_inputs`); for CPU tensors from
    `preprocess_plain` itself. `color` is `colors_precomp` itself where
    given, and `opacity` a view of `opacities`, as in the plain version."""
    kw = dict(shs=shs, sh_degree=sh_degree, colors_precomp=colors_precomp, scales=scales,
              quats=quats, cov3d_precomp=cov3d_precomp, screen_deltas=screen_deltas,
              alive=alive)
    dev = means3d.device
    if dev.type == "cpu":
        return preprocess_plain(means3d, opacities, cam, scale_modifier=scale_modifier, **kw)
    if dev.type != "cuda":
        raise ValueError(f"preprocess_kernel supports cpu and cuda tensors, not {dev}")
    check_inputs(means3d, opacities, cam, **kw)
    n = means3d.shape[0]
    opacity = opacities.reshape(n)

    xy = torch.empty(n, 2, device=dev)
    depth = torch.empty(n, device=dev)
    conic = torch.empty(n, 3, device=dev)
    color = torch.empty(n, 3, device=dev) if colors_precomp is None else colors_precomp
    radii = torch.empty(n, dtype=torch.int32, device=dev)
    rect = torch.empty(n, 4, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = load("preprocess")
        # the inputs the call reads; sh_degree -1 tells the kernel the colours are given
        sc, qu = (scales, quats) if cov3d_precomp is None else (None, None)
        sh, deg = (shs, sh_degree) if colors_precomp is None else (None, -1)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.scorp_preprocess(
                *(t.data_ptr() if t is not None else None
                  for t in (means3d, opacity, sc, qu, cov3d_precomp, sh, screen_deltas, alive,
                            cam.viewmatrix, cam.projmatrix, cam.campos, cam.tanfovx,
                            cam.tanfovy)),
                n, cam.width, cam.height, deg, sh.shape[1] if sh is not None else 0,
                float(scale_modifier),
                *(t.data_ptr() if t is not None else None
                  for t in (xy, depth, conic, color if sh is not None else None, radii, rect,
                            valid)),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"preprocess kernel launch failed: cudaError {err}")
        preprocess_kernel.launches += 1
    return Preprocessed(xy, depth, conic, color, opacity, radii, rect, valid)


preprocess_kernel.launches = 0
