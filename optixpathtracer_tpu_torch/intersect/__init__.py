"""Ray-scene intersection (port of `optixpathtracer_tpu/intersect`)."""
from . import brute, bvh_traverse, dense_kernels, walk_kernels  # noqa: F401
from .api import intersect_any, intersect_closest  # noqa: F401
from .types import Hit  # noqa: F401
