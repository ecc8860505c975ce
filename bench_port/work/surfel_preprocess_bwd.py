"""Work of the per-surfel backward: each live row's table gradient (21
floats) and parameters read once, its parameter gradients written once;
~600 f32 operations a row."""


def cost(shape: dict) -> dict:
    rows = shape["rows"]
    return {"flops": 600.0 * rows, "bytes": 4.0 * rows * (21 + 2 * shape["param_floats"])}
