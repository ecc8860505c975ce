"""Work of the backward compositor (K3): 45 f32 operations on each pair
blended up to the pixel's last contributor, as
`chip_smoke.py:K3_FLOPS_PER_PAIR` counts them (atomics not counted);
bytes: each stream row with its index (44) and tile range (8) read once,
each pixel's gradients (colour, depth, alpha), final transmittance and
contributor count read once, each live row's table gradient (10 floats)
written once."""


def cost(shape: dict) -> dict:
    return {"flops": 45.0 * shape["pairs"],
            "bytes": 44.0 * shape["keys"] + 8.0 * shape["tiles"] + 28.0 * shape["pixels"]
            + 40.0 * shape["rows"]}
