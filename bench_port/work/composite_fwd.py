"""Work of the forward compositor (K2; K5 for surfels has its own file):
24 f32 operations on each (pixel, Gaussian) pair blended up to the pixel's
last contributor (shape["pairs"]: the reference's count, pairs at alpha >=
1/255), as `chip_smoke.py:K2_FLOPS_PER_PAIR` counts them; bytes: each
stream row (40 bytes) and tile range (8) read once, each pixel's colour,
depth and alpha written once, and in training its contributor count and
final transmittance."""


def cost(shape: dict) -> dict:
    out_words = 5 + (2 if shape["train"] else 0)
    return {"flops": 24.0 * shape["pairs"],
            "bytes": 40.0 * shape["keys"] + 8.0 * shape["tiles"] + 4.0 * out_words * shape["pixels"]}
