"""Work of the 2DGS normal-consistency term, forward and backward: the
normal map (3 floats), median depth and alpha read once, the depth's
unprojection, central differences, cross product and normalisation (~60
f32 operations a pixel each way), the normal and depth gradients (4
floats) written once."""


def cost(shape: dict) -> dict:
    return {"flops": 120.0 * shape["pixels"], "bytes": 36.0 * shape["pixels"]}
