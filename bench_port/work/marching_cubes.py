"""Work of one triangulation of a TSDF grid (kernel M,
csrc/marching_cubes.cu), counted as what no correct implementation can
avoid, from the reference's mesh and masks of the grid
(bench_port/reference/marching_cubes.py):

- bytes: the tsdf and weight of each observed voxel read (8 B), the colour
  of each voxel at the end of a vertex's edge read (12 B), and the mesh
  written at the contract's types: 48 B a vertex (float64 position and
  colour) and 24 B a face (three int64);
- no operations: the arithmetic is float64 and a few dozen operations a
  vertex, far under the bytes' time, and bench_port/peaks.json has no
  float64 rate.

Unobserved voxels cost nothing here: a grid could keep a mask of them."""

OBSERVED_BYTES = 8
EDGE_CORNER_BYTES = 12
VERTEX_BYTES = 48
FACE_BYTES = 24


def cost(shape: dict) -> dict:
    return {"flops": 0.0,
            "bytes": float(OBSERVED_BYTES * shape["observed"]
                           + EDGE_CORNER_BYTES * shape["edge_corners"]
                           + VERTEX_BYTES * shape["vertices"] + FACE_BYTES * shape["faces"])}
