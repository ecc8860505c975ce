"""Work of the per-surfel forward (homography, depth row, adjugate rows,
view normal, rect, SH colour): each live row's parameters read once, its
stream-table row (21 floats) and screen extent (radius and rect, 5 words)
written once; ~300 f32 operations a row."""


def cost(shape: dict) -> dict:
    rows = shape["rows"]
    return {"flops": 300.0 * rows, "bytes": 4.0 * rows * (shape["param_floats"] + 26)}
