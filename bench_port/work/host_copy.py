"""Work of the image's copy to host memory: 3 floats a pixel over the
PCIe link, one way."""


def cost(shape: dict) -> dict:
    return {"flops": 0.0, "bytes": 12.0 * shape["pixels"], "link": "pcie"}
