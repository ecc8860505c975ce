"""Work of the per-Gaussian backward: each live row's table gradient (10
floats) and parameters read once, its parameter gradients written once;
~500 f32 operations a row (twice the forward)."""


def cost(shape: dict) -> dict:
    rows = shape["rows"]
    return {"flops": 500.0 * rows, "bytes": 4.0 * rows * (10 + 2 * shape["param_floats"])}
