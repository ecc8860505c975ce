"""Kernel T: one view's TSDF update of a dense voxel grid on the card
(`csrc/tsdf_fuse.cu`), one thread a voxel, in place.

`tsdf_fuse` is the wrapper. It launches the kernel for CUDA tensors and
raises for any other device: the plain version, `pipeline/mesh.py:
_tsdf_update` over voxel centres made in blocks (`_voxel_centres`), is what
`TsdfVolume.integrate` runs on the CPU. `tsdf_fuse.launches` counts the
kernel's launches.

The kernel makes each voxel's f32 world centre from its flat index, in
float64 as `_voxel_centres` does with numpy, and repeats `_tsdf_update`'s
operations in their order, so the grid it leaves is bit for bit the plain
version's on the same inputs. It reads the camera's matrix and field of
view on the device: nothing goes to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ._build import check_tensor, load

REPLACES = "none: the JAX package's TSDF update (scorp_tpu/pipeline/mesh.py) is plain jitted XLA"
SOURCE = "scorp_tpu_torch/csrc/tsdf_fuse.cu"


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
    lib = load("tsdf_fuse")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_tsdf_fuse(
            int(bool(contracted)), int(res), *(float(b) for b in base), float(scale),
            *(t.data_ptr() for t in (cam.viewmatrix, cam.tanfovx, cam.tanfovy, depth, color)),
            w, h, float(sdf_trunc), float(depth_trunc),
            tsdf.data_ptr(), weight.data_ptr(), colors.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tsdf_fuse kernel launch failed: cudaError {err}")
    tsdf_fuse.launches += 1


tsdf_fuse.launches = 0
