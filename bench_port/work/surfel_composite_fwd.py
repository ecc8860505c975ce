"""Work of the surfel forward compositor in training (K5): 42 f32
operations on each (pixel, surfel) pair blended up to the pixel's last
contributor, as `chip_smoke.py:K4_FLOPS_PER_PAIR` counts them; bytes: each
stream row (84) and tile range (8) read once, 15 floats a pixel written
once (the maps and the residuals K6 reads), as
`chip_smoke.py:surfel_forward_bound` counts them."""


def cost(shape: dict) -> dict:
    return {"flops": 42.0 * shape["pairs"],
            "bytes": 84.0 * shape["keys"] + 8.0 * shape["tiles"] + 60.0 * shape["pixels"]}
