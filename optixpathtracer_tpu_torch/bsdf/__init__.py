"""BSDF library (port of `optixpathtracer_tpu/bsdf`): f/sample/pdf batched
over wavefronts in the local shading frame (normal = +z): diffuse,
conductor, dielectric, the layered glossy-diffuse walk, and the dispatch
around them."""
from . import (conductor, dielectric, diffuse, dispatch,  # noqa: F401
               glossy_diffuse)
from .base import BSDFSample, where_sample  # noqa: F401
from .dispatch import (CONDUCTOR, DIELECTRIC, DIFFUSE,  # noqa: F401
                       GLOSSY_DIFFUSE, METALLIC_MIX, MaterialParams)
