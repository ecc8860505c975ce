"""The plain reference: PyTorch only, float32, importing nothing of the
program (scorp_tpu_torch) and nothing of JAX."""


def raster_of(primitive: str):
    """The reference rasterizer module of a configuration's primitive."""
    if primitive == "3dgs":
        from . import raster3d

        return raster3d
    if primitive == "2dgs":
        from . import raster2d

        return raster2d
    raise KeyError(f"no reference rasterizer for {primitive!r}")
