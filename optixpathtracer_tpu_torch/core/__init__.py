"""Core math, RNG, Fresnel and microfacet terms (port of
`optixpathtracer_tpu/core`)."""
from . import fresnel, math, microfacet, rng  # noqa: F401
