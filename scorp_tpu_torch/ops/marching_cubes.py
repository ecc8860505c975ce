"""Kernel M: level-0 marching cubes of a dense TSDF grid on the card
(`csrc/marching_cubes.cu`), the mesh of `pipeline/marching_cubes.py:
marching_cubes` bit for bit, and its world map.

`marching_cubes` is the wrapper. It launches the kernel for CUDA tensors
and raises for any other device: `TsdfVolume.triangulate` runs the plain
function, a slab of planes at a time, on the CPU.

The case tables are the Python module's `TRI_TABLE`, `LOOP_MASK` and
`EDGE_BASE`, uploaded once a device. A call runs the count pass (one
launch, every weight read once), scans the row counts on the device, reads
the totals to the host (its one synchronisation), allocates the mesh and
the chunk lists to size and runs the list, vertex and emit passes (three
launches) over the 32-corner chunks near the surface only. Nothing of the
grid is kept between calls.

Counters (host ints, summed over calls): `marching_cubes.launches` counts
the triangulations launched on the card, after the count pass launched
without error: a grid under two voxels a side launches nothing and counts
nothing. `marching_cubes.chunks` adds the 32-corner chunks of each grid
launched on (NX NY ceil(NZ / 32)), `marching_cubes.active_chunks` the chunks
the later passes visited (with an edge vertex or an active cell), from the
same read of the totals: their ratio is the share of the grid the later
passes engage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import marching_cubes as mc
from ..utils.trace import span
from ._build import check_tensor, load

REPLACES = ("none: the JAX package triangulates on the host with numpy "
            "(scorp_tpu/pipeline/marching_cubes.py)")
SOURCE = "scorp_tpu_torch/csrc/marching_cubes.cu"

MAX_TRIS = 8  # csrc/marching_cubes.cu kMaxTris
# the count pass's tile (csrc/marching_cubes.cu kTX, kTY, kTZ): corner
# planes, rows and corners along z
TILE = (8, 14, 128)
# the count pass's row counters, in csrc/marching_cubes.cu's order
COUNTS = ("vertices", "vertex_chunks", "centroids", "faces", "cell_chunks")

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
    rows, words = nx * ny, -(-nz // 32)
    with torch.cuda.device(dev):
        tables = _device_tables(dev)
        chunk_words = torch.empty(rows * words, dtype=torch.int64, device=dev)
        counts = torch.zeros(len(COUNTS) * rows + 1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scorp_mc_count(tsdf.data_ptr(), weight.data_ptr(), nx, ny, nz,
                                 tables.data_ptr(), chunk_words.data_ptr(), counts.data_ptr(),
                                 stream)
        if err != 0:
            raise RuntimeError(f"marching_cubes count launch failed: cudaError {err}")
        marching_cubes.launches += 1
        # one scan over the row counts in turn (each count's rows start where
        # the one before ends), and the call's one read to the host: each
        # count's end and the chunks the later passes visit
        ends = torch.cumsum(counts[:-1], 0)
        totals = torch.cat([ends[rows - 1::rows], counts[-1:]])
        with span("sync.mc_totals"):
            *cum, touched = totals.tolist()
        nverts, vchunks, ncents, nfaces, cchunks = np.diff([0] + cum).tolist()
        marching_cubes.chunks += rows * words
        marching_cubes.active_chunks += touched
        if nfaces == 0:
            return empty
        verts = torch.empty((nverts + ncents, 3), dtype=torch.float64, device=dev)
        vcols = torch.empty_like(verts)
        faces = torch.empty((nfaces, 3), dtype=torch.int64, device=dev)
        # the later passes' lists (csrc/marching_cubes.cu scorp_mc_emit), int64
        # words: a vertex chunk's ballots (16 B), entry and first vertex; each
        # chunk's slot (int32); a cell chunk's entry, first centroid and face
        scratch = torch.empty(4 * vchunks + -(-rows * words // 2) + 3 * cchunks,
                              dtype=torch.int64, device=dev)
        scale, centre = (1.0, (0.0, 0.0, 0.0)) if contract is None else contract
        err = lib.scorp_mc_emit(
            tsdf.data_ptr(), colors.data_ptr(), nx, ny, nz, tables.data_ptr(),
            chunk_words.data_ptr(), counts.data_ptr(), ends.data_ptr(), nverts,
            vchunks, cchunks,
            *(float(o) for o in np.asarray(origin, np.float64).reshape(3)), float(voxel_size),
            int(contract is not None), float(scale),
            *(float(c) for c in np.asarray(centre, np.float64).reshape(3)),
            verts.data_ptr(), vcols.data_ptr(), faces.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"marching_cubes emit launch failed: cudaError {err}")
    return verts, faces, vcols


marching_cubes.launches = 0
marching_cubes.chunks = 0
marching_cubes.active_chunks = 0
