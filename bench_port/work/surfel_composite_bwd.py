"""Work of the surfel backward compositor (K6): ~130 f32 operations on
each pair blended up to the pixel's last contributor (atomics not
counted); bytes: each stream row with its index (88) and tile range (8)
read once, 15 floats a pixel of cotangents and residuals read once, each
live row's table gradient (21 floats) written once, as
`chip_smoke.py:surfel_backward_bound` counts them."""


def cost(shape: dict) -> dict:
    return {"flops": 130.0 * shape["pairs"],
            "bytes": 88.0 * shape["keys"] + 8.0 * shape["tiles"] + 60.0 * shape["pixels"]
            + 84.0 * shape["rows"]}
