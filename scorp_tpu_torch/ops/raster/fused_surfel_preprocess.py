"""The fused surfel preprocess: every field of `SurfelFrame`, for every
row, in one CUDA launch (`csrc/surfel_preprocess.cu`).

`preprocess_surfel_kernel` is the wrapper, as `preprocess_kernel` is the
3DGS one's: it launches the kernel for CUDA tensors and runs
`surfel.surfel_frame_plain`, the plain stages `preprocess_surfel`,
`surfel_table` and `surfel_cull_ellipses`, for CPU tensors. The kernel has
no backward, so `rasterize_surfel` calls the plain stages where an input
requires grad, and this wrapper everywhere else.
`preprocess_surfel_kernel.launches` counts the kernel's launches.

The kernel repeats the plain stages' operations in their order (built with
-fmad=false, with explicit multiply-adds where a PyTorch kernel or cuBLAS
contracts), so its outputs are bit-identical to theirs on the card; the
source's header says what that takes. The camera's A, b (`surfel_camera`)
are made here by the plain version's own ops. The zrow's [N, 3] @ [3]
product, which cuBLAS associates in one of two ways by N, is repeated in
the way `zrow_order` finds cuBLAS takes at the call's N.
"""

from __future__ import annotations

import torch

from ...core.camera import Camera
from .._build import check_tensor, load
from .surfel import SURFEL_COLS, SurfelFrame, surfel_camera, surfel_frame_plain

REPLACES = ("scorp_tpu/ops/raster/surfel.py preprocess_surfel, surfel_table, "
            "surfel_cull_ellipses (no TPU kernel: XLA fuses them)")
SOURCE = "scorp_tpu_torch/csrc/surfel_preprocess.cu"
MAX_SH_DEGREE = 3
_ZROW_ORDERS: dict = {}  # (rows, device) -> zrow_order's answer


def zrow_order(n: int, device: torch.device) -> int:
    """How cuBLAS's sgemv adds the three terms of an [n, 3] @ [3] product
    as `preprocess_surfel` forms zrow (rows at stride 3, a column of the
    view matrix at stride 4): 0 for (a0 b0 + a1 b1) + a2 b2, 1 for
    (a0 b0 + a2 b2) + a1 b1 (on an H100 under cuBLAS 12.8: 0 up to at least
    250,000 rows, 1 at 1,503,232). Found once per (n, device) from a probe
    row (1, -1, 2^-30) against ones, whose two sums are 2^-30 and 0: one
    small product and one read to the host."""
    key = (n, device)
    if key not in _ZROW_ORDERS:
        rows = torch.zeros(n, 3, device=device)
        rows[0] = torch.tensor([1.0, -1.0, 2.0 ** -30])
        column = torch.ones(4, 4, device=device)[:3, :3][:, 2]
        got = float((rows @ column)[0])
        if got not in (2.0 ** -30, 0.0):
            raise RuntimeError(f"cuBLAS sums an [{n}, 3] @ [3] product in an order the "
                               f"surfel preprocess kernel does not know (probe read {got!r})")
        _ZROW_ORDERS[key] = 0 if got else 1
    return _ZROW_ORDERS[key]


def check_inputs(means3d: torch.Tensor, opacities: torch.Tensor, cam: Camera, *,
                 shs: torch.Tensor | None, sh_degree: int, colors_precomp: torch.Tensor | None,
                 scales: torch.Tensor | None, quats: torch.Tensor | None,
                 screen_deltas: torch.Tensor | None, alive: torch.Tensor | None) -> None:
    """Raise unless the kernel takes these inputs: contiguous float32 on
    `means3d`'s device (`alive` bool [N]), scales [N, 2] and quats [N, 4],
    and shs [N, K, 3] at an SH degree of 0-3 with K >= (degree + 1)^2, or
    colors_precomp [N, 3]. `shs` beside colours is not read, so not
    checked."""
    dev = means3d.device
    n = means3d.shape[0]
    f32 = torch.float32
    check_tensor(means3d, "means3d", f32, (n, 3), dev)
    check_tensor(opacities.reshape(n), "opacities", f32, (n,), dev)
    if scales is None or quats is None:
        raise ValueError("preprocess_surfel_kernel needs scales and quats")
    check_tensor(scales, "scales", f32, (n, 2), dev)
    check_tensor(quats, "quats", f32, (n, 4), dev)
    if colors_precomp is None:
        if shs is None or not 0 <= sh_degree <= MAX_SH_DEGREE:
            raise ValueError(f"preprocess_surfel_kernel needs shs and an SH degree of 0-"
                             f"{MAX_SH_DEGREE} (got {sh_degree}), or colors_precomp")
        bands = shs.shape[1] if shs.dim() == 3 else 0
        if bands < (sh_degree + 1) ** 2:
            raise ValueError(f"shs of shape {tuple(shs.shape)} cannot evaluate degree "
                             f"{sh_degree}")
        check_tensor(shs, "shs", f32, (n, bands, 3), dev)
    else:
        check_tensor(colors_precomp, "colors_precomp", f32, (n, 3), dev)
    if screen_deltas is not None:
        check_tensor(screen_deltas, "screen_deltas", f32, (n, 2), dev)
    if alive is not None:
        check_tensor(alive, "alive", torch.bool, (n,), dev)
    check_tensor(cam.viewmatrix, "viewmatrix", f32, (4, 4), dev)
    check_tensor(cam.campos, "campos", f32, (3,), dev)
    check_tensor(cam.tanfovx, "tanfovx", f32, (), dev)
    check_tensor(cam.tanfovy, "tanfovy", f32, (), dev)


def preprocess_surfel_kernel(means3d: torch.Tensor, opacities: torch.Tensor, cam: Camera, *,
                             shs: torch.Tensor | None = None, sh_degree: int = 0,
                             colors_precomp: torch.Tensor | None = None,
                             scales: torch.Tensor | None = None,
                             quats: torch.Tensor | None = None, scale_modifier: float = 1.0,
                             screen_deltas: torch.Tensor | None = None,
                             alive: torch.Tensor | None = None) -> SurfelFrame:
    """`surfel_frame_plain`'s outputs: for CUDA tensors in one launch on the
    current stream, raising on inputs the kernel does not take
    (`check_inputs`; a strided input is first copied to a contiguous one, as
    the plain stages' ops would read it), and reading nothing back to the
    host but `zrow_order`'s probe, once per row count; for CPU tensors from
    `surfel_frame_plain` itself. `xy` is a view of the table's columns
    12-13."""
    dev = means3d.device
    if dev.type == "cpu":
        return surfel_frame_plain(means3d, opacities, cam, shs=shs, sh_degree=sh_degree,
                                  colors_precomp=colors_precomp, scales=scales, quats=quats,
                                  scale_modifier=scale_modifier, screen_deltas=screen_deltas,
                                  alive=alive)
    if dev.type != "cuda":
        raise ValueError(f"preprocess_surfel_kernel supports cpu and cuda tensors, not {dev}")
    n = means3d.shape[0]
    means3d, opacity, shs, colors_precomp, scales, quats, screen_deltas, alive = (
        t if t is None else t.contiguous()
        for t in (means3d, opacities.reshape(n), shs, colors_precomp, scales, quats,
                  screen_deltas, alive))
    check_inputs(means3d, opacity, cam, shs=shs, sh_degree=sh_degree,
                 colors_precomp=colors_precomp, scales=scales, quats=quats,
                 screen_deltas=screen_deltas, alive=alive)

    table = torch.empty(n, SURFEL_COLS, device=dev)
    ell = torch.empty(n, 6, device=dev)
    circ = torch.empty(n, 6, device=dev)
    depth = torch.empty(n, device=dev)
    radii = torch.empty(n, dtype=torch.int32, device=dev)
    rect = torch.empty(n, 4, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        if table.data_ptr() % 16 or ell.data_ptr() % 8 or circ.data_ptr() % 8:
            raise RuntimeError("the surfel preprocess's outputs are misaligned")
        lib = load("surfel_preprocess")
        order = zrow_order(n, dev)
        _, _, cam_a, cam_b = surfel_camera(cam)
        # the colour source the call reads; sh_degree -1 tells the kernel the colours are given
        sh, deg = (shs, sh_degree) if colors_precomp is None else (None, -1)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.scorp_surfel_preprocess(
                *(t.data_ptr() if t is not None else None
                  for t in (means3d, opacity, scales, quats, sh, colors_precomp, screen_deltas,
                            alive, cam.viewmatrix, cam_a, cam_b, cam.campos)),
                n, cam.width, cam.height, deg, sh.shape[1] if sh is not None else 0, order,
                float(scale_modifier),
                *(t.data_ptr() for t in (table, ell, circ, depth, radii, rect, valid)),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"surfel preprocess kernel launch failed: cudaError {err}")
        preprocess_surfel_kernel.launches += 1
    return SurfelFrame(table[:, 12:14], depth, rect, valid, radii, table, ell, circ)


preprocess_surfel_kernel.launches = 0
