"""Work of Adam over every live parameter: parameter, gradient and both
moments read once, parameter and moments written once (28 bytes a float),
~12 f32 operations a float."""


def cost(shape: dict) -> dict:
    floats = float(shape["rows"]) * shape["param_floats"]
    return {"flops": 12.0 * floats, "bytes": 28.0 * floats}
