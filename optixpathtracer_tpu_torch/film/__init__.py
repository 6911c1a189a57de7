"""Film and image IO: color transfer, EXR/PNG/BMP, quality metrics
(port of `optixpathtracer_tpu/film`)."""
from . import color, metrics  # noqa: F401
from .exr import read_exr, write_exr  # noqa: F401
from .image_io import to_display, write_bmp, write_png  # noqa: F401
