"""Kernel T: one view's TSDF update of a dense voxel grid on the card
(`csrc/tsdf_fuse.cu`), in place, brick by brick.

`tsdf_fuse` is the wrapper. It launches the kernel for CUDA tensors and
raises for any other device: the plain version, `pipeline/mesh.py:
_tsdf_update` over voxel centres made in blocks (`_voxel_centres`), is what
`TsdfVolume.integrate` runs on the CPU.

The kernel walks the grid as bricks of 2^BRICK_LOG2 voxels a side and
culls, by one conservative float64 test a brick, every brick that no voxel
of it can update (behind the camera, beyond the truncations' reach, outside
the image). The voxels of the other bricks make their f32 world centre from
their index, in float64 as `_voxel_centres` does with numpy, and repeat
`_tsdf_update`'s operations in their order, so the grid it leaves is bit
for bit the plain version's on the same inputs. It reads the camera's
matrix and field of view on the device: nothing goes to the host.

Counters: `tsdf_fuse.launches` counts the kernel's launches and
`tsdf_fuse.bricks` the bricks of their grids; `tsdf_fuse.live_bricks()`
reads (and so synchronises) the device's count of bricks the launches did
not cull.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ._build import check_tensor, load

REPLACES = "none: the JAX package's TSDF update (scorp_tpu/pipeline/mesh.py) is plain jitted XLA"
SOURCE = "scorp_tpu_torch/csrc/tsdf_fuse.cu"

# a brick is 8^3 voxels (PERF.md's measurement of 4^3, 8^3 and 16^3)
BRICK_LOG2 = 3
# a block tests a lattice of 4^3 bricks spread over the grid, or 2^3 or 1
# where the grid has too few bricks to make MIN_BLOCKS blocks of 4^3
MIN_BLOCKS = 4096
MAX_LATTICE_LOG2 = 2

_live: dict[torch.device, torch.Tensor] = {}  # the device's live-brick count, by device


def brick_layout(res: int) -> tuple[int, int, int]:
    """(brick_log2, lattice_log2, bricks) of an R^3 grid: the brick and the
    lattice sides as powers of two and the grid's number of bricks."""
    side = -(-int(res) // (1 << BRICK_LOG2))
    lattice = 0
    for lg in range(MAX_LATTICE_LOG2, 0, -1):
        if (-(-side // (1 << lg))) ** 3 >= MIN_BLOCKS:
            lattice = lg
            break
    return BRICK_LOG2, lattice, side ** 3


def tsdf_fuse(tsdf: torch.Tensor, weight: torch.Tensor, colors: torch.Tensor,
              depth: torch.Tensor, color: torch.Tensor, cam: Camera, *, contracted: bool,
              res: int, base, scale: float, sdf_trunc: float, depth_trunc: float) -> None:
    """Fuse one view into an R^3 grid on the current stream: tsdf [R^3],
    weight [R^3], colors [R^3, 3] (f32, contiguous, updated in place) from
    depth [H, W] and color [3, H, W] (f32) seen by `cam`. The grid's voxels:
    bounded, (idx + 0.5) * scale + base per axis; contracted, the
    contracted cube [-2, 2]^3 at 4 / R a voxel uncontracted, times `scale`
    (the scene's radius) plus `base` (its centre). `sdf_trunc` and
    `depth_trunc` are rounded to f32, as the plain version rounds them."""
    dev = tsdf.device
    if dev.type != "cuda":
        raise ValueError(f"tsdf_fuse launches a CUDA kernel; the grid is on {dev} "
                         "(TsdfVolume.integrate runs the plain version there)")
    m = int(res) ** 3
    w, h = cam.width, cam.height
    for t, name, dtype, shape in (
            (tsdf, "tsdf", torch.float32, (m,)), (weight, "weight", torch.float32, (m,)),
            (colors, "colors", torch.float32, (m, 3)), (depth, "depth", torch.float32, (h, w)),
            (color, "color", torch.float32, (3, h, w)),
            (cam.viewmatrix, "viewmatrix", torch.float32, (4, 4)),
            (cam.tanfovx, "tanfovx", torch.float32, ()),
            (cam.tanfovy, "tanfovy", torch.float32, ())):
        check_tensor(t, name, dtype, shape, dev)
    base = np.asarray(base, np.float64).reshape(3)
    brick_log2, lattice_log2, bricks = brick_layout(res)
    lib = load("tsdf_fuse")
    with torch.cuda.device(dev):
        live = _live.get(dev)
        if live is None:
            live = _live[dev] = torch.zeros((), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_tsdf_fuse(
            int(bool(contracted)), int(res), brick_log2, lattice_log2,
            *(float(b) for b in base), float(scale),
            *(t.data_ptr() for t in (cam.viewmatrix, cam.tanfovx, cam.tanfovy, depth, color)),
            w, h, float(sdf_trunc), float(depth_trunc),
            tsdf.data_ptr(), weight.data_ptr(), colors.data_ptr(), live.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tsdf_fuse kernel launch failed: cudaError {err}")
    tsdf_fuse.launches += 1
    tsdf_fuse.bricks += bricks


def live_bricks() -> int:
    """The bricks that every launch so far, on every device, did not cull:
    read from the devices, after their work so far (a synchronisation)."""
    return sum(int(c.item()) for c in _live.values())


tsdf_fuse.launches = 0
tsdf_fuse.bricks = 0
tsdf_fuse.live_bricks = live_bricks
