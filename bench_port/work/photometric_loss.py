"""Work of L1 + SSIM, forward and backward, on the 3-channel image: the
image and the ground truth read once, the image's gradient written once;
~700 f32 operations a channel value (five separable 11-tap windows each
way, ~220 forward and twice that backward)."""


def cost(shape: dict) -> dict:
    values = 3.0 * shape["pixels"]
    return {"flops": 700.0 * values, "bytes": 12.0 * values}
