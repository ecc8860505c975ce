"""Work of the routing: the depth order of the live rows (a key and an
index read and written once each), the (tile, Gaussian) keys written,
sorted (read and written once) and their table rows gathered into the
stream (40 bytes a key written once, its index read once). Only keys with
a pixel at alpha >= 1/255 count (shape["keys"]); no operations."""


def cost(shape: dict) -> dict:
    return {"flops": 0.0, "bytes": 16.0 * shape["rows"] + shape["keys"] * (4 + 8 + 4 + 40)}
