"""optixpathtracer_tpu_torch: the PyTorch + CUDA port of optixpathtracer_tpu.

The JAX package `optixpathtracer_tpu` stays the reference; this package
mirrors its layout and module names so every port module sits at the same
path as its counterpart. It imports `torch` and never `jax`.

Every module of the JAX package is ported: the forward render path of
every preset (textures, alpha cutout and the `trace_paths` options
included), the material-table gradients, multi-device rendering and the
front end.
  core/       math helpers with device-independent rounding, the TEA/LCG
              per-lane RNG, Fresnel and microfacet helpers
  camera/     matrix camera + raygen (pixel-centre and jittered rays)
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
              the lights (autograd), their finite-difference check, and the
              differentiable replay of the material-test scenes
  dist/       pixel rows sharded over the ranks of a torch.distributed
              group (one process a GPU, NCCL; gloo on the CPU), the frame
              gathered, material gradients all-reduced
  film/       sRGB/AgX transfer, EXR (the reference's bytes), PNG, BMP,
              MSE / SSIM / FLIP
  config.py, render.py, cli.py, preview.py
              RenderConfig and its JSON files, checkpointed progressive
              rendering (`render_config`), the command line
              (`python -m optixpathtracer_tpu_torch.cli`), the browser
              preview; scene/gltf.py loads and writes glTF
  spans.py    the `tracer.*` layer spans (frame, bounce, intersection
              stages, shading, BSDF), open only while a torch.profiler
              records

Entry points build on the GPU unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`), and raise where there is no GPU.

The CUDA kernels are compiled at first use into `_build/` (see `_build.py`);
importing this package needs neither a GPU nor `nvcc`.
"""

__version__ = "0.1.0"
