"""Work of one view's TSDF update (kernel T, csrc/tsdf_fuse.cu), counted as
what no correct implementation can avoid, from the reference's masks of the
view over the whole grid (`inside`: voxels in front of the camera and in
the image; `valid`: those the update counts):

- f32 operations: 41 a voxel in the image (the projection's three rows,
  18, its two divisions and two multiply-adds, 6; the tap weights, 4; the
  depth's four taps, 11; the sdf, 2) and 49 more a valid voxel (the clamp,
  2; the weight and its floor, 2; the tsdf's multiply-add and division, 3;
  the colour's 3 x 11 taps and 3 x 3 for its average), a multiply-add
  counted as two;
- bytes: each valid voxel's tsdf, weight and colour read and written (40 B)
  and the view's depth and colour maps read once (16 B a pixel).

Voxels outside the image, and the voxel centres' float64 arithmetic, are
not counted: a kernel could cull whole bricks of voxels, and
bench_port/peaks.json has no float64 rate."""

INSIDE_OPS = 41
VALID_OPS = 49
STATE_BYTES = 40
MAP_BYTES = 16


def cost(shape: dict) -> dict:
    return {"flops": float(INSIDE_OPS * shape["inside"] + VALID_OPS * shape["valid"]),
            "bytes": float(STATE_BYTES * shape["valid"] + MAP_BYTES * shape["pixels"])}
