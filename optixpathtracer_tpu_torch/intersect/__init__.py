"""Ray-scene intersection (port of `optixpathtracer_tpu/intersect`)."""
from . import (brute, bvh_traverse, dense_kernels,  # noqa: F401
               packet_kernels, walk_kernels)
from .api import intersect_any, intersect_closest  # noqa: F401
from .types import Hit  # noqa: F401
