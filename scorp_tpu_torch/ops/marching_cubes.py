"""Kernel M: level-0 marching cubes of a dense TSDF grid on the card
(`csrc/marching_cubes.cu`), the mesh of `pipeline/marching_cubes.py:
marching_cubes` bit for bit, and its world map.

`marching_cubes` is the wrapper. It launches the kernel for CUDA tensors
and raises for any other device: `TsdfVolume.triangulate` runs the plain
function, a slab of planes at a time, on the CPU.

The case tables are the Python module's `TRI_TABLE`, `LOOP_MASK` and
`EDGE_BASE`, uploaded once a device. A call counts (steps 1-2 of the
kernel), scans the row counts on the device, reads the three totals to the
host (its one synchronisation), allocates the mesh to size and writes it
(steps 3-4). Nothing of the grid is kept between calls.

Counter: `marching_cubes.launches` counts the triangulations launched on
the card (four kernel launches each), after the first launch succeeded: a
grid under two voxels a side launches nothing and counts nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import marching_cubes as mc
from ._build import check_tensor, load

REPLACES = ("none: the JAX package triangulates on the host with numpy "
            "(scorp_tpu/pipeline/marching_cubes.py)")
SOURCE = "scorp_tpu_torch/csrc/marching_cubes.cu"

MAX_TRIS = 8  # csrc/marching_cubes.cu kMaxTris

_tables: dict[torch.device, torch.Tensor] = {}


def case_tables() -> np.ndarray:
    """The kernel's int32 upload: TRI_TABLE [256, MAX_TRIS, 3] (-1 past a
    case's triangles), LOOP_MASK as 12-bit edge masks [256, MAX_LOOPS] and
    EDGE_BASE [12], flat."""
    tri = mc.TRI_TABLE
    if tri.shape[1] > MAX_TRIS:
        raise ValueError(f"TRI_TABLE has {tri.shape[1]} triangles a case; the kernel holds "
                         f"{MAX_TRIS}")
    padded = np.full((256, MAX_TRIS, 3), -1, np.int64)
    padded[:, :tri.shape[1]] = tri
    loops = (mc.LOOP_MASK.astype(np.int64) << np.arange(12)).sum(-1)
    return np.concatenate([padded.ravel(), loops.ravel(), mc.EDGE_BASE]).astype(np.int32)


def _device_tables(dev: torch.device) -> torch.Tensor:
    t = _tables.get(dev)
    if t is None:
        t = _tables[dev] = torch.as_tensor(case_tables(), device=dev)
    return t


def marching_cubes(tsdf: torch.Tensor, weight: torch.Tensor, colors: torch.Tensor, shape,
                   *, origin, voxel_size: float, contract=None):
    """The mesh of an NX x NY x NZ grid on the current stream: tsdf [N],
    weight [N], colors [N, 3] (f32, contiguous, flat in C order over
    `shape`) -> (vertices [V, 3] float64, faces [F, 3] int64, colours
    [V, 3] float64) on the grid's device, with `marching_cubes`' vertices
    (p + 0.5) * voxel_size + origin, then, where `contract` is (scale,
    centre), `mesh.uncontract` of them times scale plus centre."""
    dev = tsdf.device
    if dev.type != "cuda":
        raise ValueError(f"marching_cubes launches a CUDA kernel; the grid is on {dev} "
                         "(TsdfVolume.triangulate runs the plain function there)")
    nx, ny, nz = (int(n) for n in shape)
    m = nx * ny * nz
    for t, name, dtype, shp in ((tsdf, "tsdf", torch.float32, (m,)),
                                (weight, "weight", torch.float32, (m,)),
                                (colors, "colors", torch.float32, (m, 3))):
        check_tensor(t, name, dtype, shp, dev)
    empty = (torch.zeros((0, 3), dtype=torch.float64, device=dev),
             torch.zeros((0, 3), dtype=torch.int64, device=dev),
             torch.zeros((0, 3), dtype=torch.float64, device=dev))
    if min(nx, ny, nz) < 2:
        return empty
    lib = load("marching_cubes")
    rows, words = nx * ny, -(-(nz - 1) // 32)
    with torch.cuda.device(dev):
        tables = _device_tables(dev)
        amask = torch.empty(rows * words, dtype=torch.int32, device=dev)
        counts = torch.empty((3, rows), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_mc_count(tsdf.data_ptr(), weight.data_ptr(), nx, ny, nz,
                                 tables.data_ptr(), amask.data_ptr(), counts.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"marching_cubes count launch failed: cudaError {err}")
        marching_cubes.launches += 1
        # one scan over the three count rows in turn (a scan of a [3, rows]
        # tensor along its rows runs three rows wide), each row's start taken
        # off after
        ends = torch.cumsum(counts.view(-1), 0).view(3, rows)
        ends = ends - torch.cat([ends.new_zeros(1), ends[:2, -1]])[:, None]
        nverts, ncents, nfaces = ends[:, -1].tolist()  # the call's one read to the host
        if nfaces == 0:
            return empty
        starts = ends - counts
        verts = torch.empty((nverts + ncents, 3), dtype=torch.float64, device=dev)
        vcols = torch.empty_like(verts)
        faces = torch.empty((nfaces, 3), dtype=torch.int64, device=dev)
        vcode = torch.empty(nverts, dtype=torch.int32, device=dev)
        scale, centre = (1.0, (0.0, 0.0, 0.0)) if contract is None else contract
        err = lib.scorp_mc_emit(
            tsdf.data_ptr(), colors.data_ptr(), nx, ny, nz, tables.data_ptr(),
            amask.data_ptr(), counts.data_ptr(), starts.data_ptr(), nverts,
            *(float(o) for o in np.asarray(origin, np.float64).reshape(3)), float(voxel_size),
            int(contract is not None), float(scale),
            *(float(c) for c in np.asarray(centre, np.float64).reshape(3)),
            verts.data_ptr(), vcols.data_ptr(), faces.data_ptr(), vcode.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"marching_cubes emit launch failed: cudaError {err}")
    return verts, faces, vcols


marching_cubes.launches = 0
