"""Work of the surfel forward compositor on the eval path (K4,
csrc/surfel_composite.cu<false>): 42 f32 operations on each (pixel,
surfel) pair blended up to the pixel's last contributor, as K5 (the same
body); bytes: each stream row (21 floats, 84) and tile range (8) read
once, and 10 floats a pixel written once: the colour (3) and the allmap's
alpha, expected depth, normal (3), median depth and distortion. K4 writes
none of the residuals K5 keeps for the backward."""


def cost(shape: dict) -> dict:
    return {"flops": 42.0 * shape["pairs"],
            "bytes": 84.0 * shape["keys"] + 8.0 * shape["tiles"] + 40.0 * shape["pixels"]}
