"""optixpathtracer_tpu_torch: the PyTorch + CUDA port of optixpathtracer_tpu.

The JAX package `optixpathtracer_tpu` stays the reference; this package
mirrors its layout and module names so every port module sits at the same
path as its counterpart. It imports `torch` and never `jax`.

Ported so far: the whole forward render path of every preset, textures,
alpha cutout and the `trace_paths` options included, and the
material-table gradients.
  core/       math helpers with device-independent rounding, the TEA/LCG
              per-lane RNG, Fresnel and microfacet helpers
  camera/     matrix camera + raygen
  scene/      data model, BVH build (numpy + the native C++ builder,
              compiled from `csrc/bvh_builder.cpp`), procedural presets,
              textures, flattening into a torch SceneData with the
              opaque/cutout split and the walk layout
  intersect/  brute-force oracle, the skip-link BVH engine (CPU), the
              dense, walk and packet engines, each with its kernels
              hand-written in CUDA for Hopper (`csrc/dense_intersect.cu`,
              `walk_intersect.cu`, `packet_intersect.cu`) and plain
              PyTorch versions for the CPU, and the detach/refine API
  bsdf/       the diffuse, conductor, dielectric and layered glossy-diffuse
              lobes and their dispatch
  integrate/  surface context (textured), the wavefront path integrator
              with NEE and its ray, segment and material sorts, and the
              alpha-cutout re-trace chains
  diff/       gradients of a rendered loss w.r.t. the material table and
              the lights (autograd), and their finite-difference check

Not ported yet: multi-device rendering and the front end (CLI, config,
film output).

The CUDA kernels are compiled at first use into `_build/` (see `_build.py`);
importing this package needs neither a GPU nor `nvcc`.
"""

__version__ = "0.1.0"
