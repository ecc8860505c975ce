"""Work of the per-Gaussian forward (projection, EWA covariance, conic,
rect, SH colour): each live row's parameters read once, its table row (10
floats) and screen extent (radius and rect, 5 words) written once; ~250
f32 operations a row (SH degree 3 ~110, covariance and projection ~140)."""


def cost(shape: dict) -> dict:
    rows = shape["rows"]
    return {"flops": 250.0 * rows, "bytes": 4.0 * rows * (shape["param_floats"] + 15)}
