"""Port parity: TEA/LCG RNG bit-identity and the hemisphere sampler
(optixpathtracer_tpu_torch.core vs optixpathtracer_tpu.core), plus the
port's import isolation from JAX."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import rng as jrng
from optixpathtracer_tpu_torch.core import rng as trng

torch.set_num_threads(1)

N_SEEDS = 100_000


@pytest.fixture(scope="module")
def seeds():
    r = np.random.default_rng(1234)
    s = r.integers(0, 2**32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]  # edges of the u32 range
    return s


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_tea_bit_identical(seeds):
    other = seeds[::-1].copy()
    want = np.asarray(jrng.tea(jnp.asarray(seeds), jnp.asarray(other)))
    got = _np(trng.tea(_t(seeds), _t(other)))
    np.testing.assert_array_equal(got, want)


def test_lcg_and_rnd_bit_identical(seeds):
    jnew, jbits = jrng.lcg(jnp.asarray(seeds))
    tnew, tbits = trng.lcg(_t(seeds))
    np.testing.assert_array_equal(_np(tnew), np.asarray(jnew))
    np.testing.assert_array_equal(_np(tbits), np.asarray(jbits))
    jseed, ju = jrng.rnd(jnp.asarray(seeds))
    tseed, tu = trng.rnd(_t(seeds))
    np.testing.assert_array_equal(_np(tseed), np.asarray(jseed))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    jseed, ju2 = jrng.rnd2(jnp.asarray(seeds))
    tseed, tu2 = trng.rnd2(_t(seeds))
    np.testing.assert_array_equal(_np(tseed), np.asarray(jseed))
    np.testing.assert_array_equal(tu2.numpy(), np.asarray(ju2))


def test_pixel_seed_bit_identical(seeds):
    width = 1920
    x = seeds % width
    y = (seeds // width) % 1080
    frame = seeds % 97
    want = np.asarray(jrng.pixel_seed(width, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(frame)))
    got = _np(trng.pixel_seed(width, _t(x), _t(y), _t(frame)))
    np.testing.assert_array_equal(got, want)
    # scalar frame id, as render_sample passes it
    want = np.asarray(jrng.pixel_seed(width, jnp.asarray(x), jnp.asarray(y),
                                      jnp.uint32(7)))
    got = _np(trng.pixel_seed(width, _t(x), _t(y), 7))
    np.testing.assert_array_equal(got, want)


def test_cosine_hemisphere_matches(seeds):
    """Within 1e-6 in x, y and z^2 = 1 - x^2 - y^2. XLA's and torch's
    float32 sin/cos differ by one ulp on a few percent of arguments, and
    z = sqrt(1 - x^2 - y^2) amplifies that ulp by x/z at grazing samples
    (measured up to 6e-6 in z at z ~ 0.02), so z is held in its
    well-conditioned squared form."""
    jseed, jw = jrng.sample_cosine_hemisphere(jnp.asarray(seeds))
    tseed, tw = trng.sample_cosine_hemisphere(_t(seeds))
    jw, tw = np.asarray(jw), tw.numpy()
    np.testing.assert_array_equal(_np(tseed), np.asarray(jseed))
    np.testing.assert_allclose(tw[:, :2], jw[:, :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw[:, 2] ** 2, jw[:, 2] ** 2, rtol=0,
                               atol=1e-6)
    assert (tw[:, 2] >= 0).all()
    jseed, jp = jrng.sample_uniform_disk_concentric(jnp.asarray(seeds))
    tseed, tp = trng.sample_uniform_disk_concentric(_t(seeds))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


SLICE_MODULES = [
    "optixpathtracer_tpu_torch",
    "optixpathtracer_tpu_torch._build",
    "optixpathtracer_tpu_torch.native",
    "optixpathtracer_tpu_torch.core.math",
    "optixpathtracer_tpu_torch.core.rng",
    "optixpathtracer_tpu_torch.core.fresnel",
    "optixpathtracer_tpu_torch.core.microfacet",
    "optixpathtracer_tpu_torch.camera.camera",
    "optixpathtracer_tpu_torch.scene.types",
    "optixpathtracer_tpu_torch.scene.bvh",
    "optixpathtracer_tpu_torch.scene.procedural",
    "optixpathtracer_tpu_torch.scene.flatten",
    "optixpathtracer_tpu_torch.intersect.types",
    "optixpathtracer_tpu_torch.intersect.brute",
    "optixpathtracer_tpu_torch.intersect.dense_kernels",
    "optixpathtracer_tpu_torch.intersect.walk_kernels",
    "optixpathtracer_tpu_torch.intersect.bvh_traverse",
    "optixpathtracer_tpu_torch.intersect.api",
    "optixpathtracer_tpu_torch.bsdf.base",
    "optixpathtracer_tpu_torch.bsdf.diffuse",
    "optixpathtracer_tpu_torch.bsdf.conductor",
    "optixpathtracer_tpu_torch.bsdf.dielectric",
    "optixpathtracer_tpu_torch.bsdf.glossy_diffuse",
    "optixpathtracer_tpu_torch.bsdf.dispatch",
    "optixpathtracer_tpu_torch.integrate.surface",
    "optixpathtracer_tpu_torch.integrate.path",
    "chip_smoke",
]


def test_port_imports_no_jax():
    """A fresh interpreter imports the whole slice without pulling in jax
    (the port must run where jax is not installed), and with CUDA hidden,
    so neither a GPU nor nvcc is needed to import it."""
    code = (
        "import importlib, sys\n"
        f"mods = {SLICE_MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib',\n"
        "                                            'optixpathtracer_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": "."}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(SLICE_MODULES)}"


def test_generate_rays_matches_cornell_camera():
    from optixpathtracer_tpu.camera.camera import generate_rays as jgen
    from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
    from optixpathtracer_tpu_torch.camera.camera import generate_rays as tgen
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS

    _, jcam, _ = JPRESETS["scene3_cornell"]()
    _, tcam, _ = PRESETS["scene3_cornell"]()
    w, h = 32, 24
    jparams = jcam.raygen_params(w, h)
    tparams = tcam.raygen_params(w, h, device="cpu")
    for a, b in zip(jparams, tparams):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jo, jd = jgen(*jparams, w, h)
    to, td = tgen(*tparams, w, h)
    assert td.shape == (h, w, 3)
    # bit-identical: the port rounds the 4x4 products and the square root
    # of the normalisation exactly as XLA does (core.math.sqrt)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


RAY_PRESETS = ("hall", "hall_small", "scene2_sponza_middle",
               "scene6_sponza_up", "scene1_spheres", "scene3_cornell",
               "scene4_dragon_glossy", "layered")


@pytest.mark.parametrize("size", [12, 33])
@pytest.mark.parametrize("name", RAY_PRESETS)
def test_generate_rays_match_reference_op_by_op(name, size):
    """Primary rays of rotated cameras (hall, hall_small, the sponza
    stand-ins) and axis-aligned ones, bit-identical to the reference's
    float32 `generate_rays` run op by op: the two 4x4 products round each
    product and sum in index order, as the reference's float32 matmul
    does here."""
    import jax
    from optixpathtracer_tpu.camera.camera import generate_rays as jgen
    from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
    from optixpathtracer_tpu_torch.camera.camera import generate_rays as tgen
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS

    _, jcam, _ = JPRESETS[name]()
    _, tcam, _ = PRESETS[name]()
    w, h = size, size + 3
    jparams = jcam.raygen_params(w, h)
    tparams = tcam.raygen_params(w, h, device="cpu")
    for a, b in zip(jparams, tparams):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with jax.disable_jit():
        jo, jd = jgen(*jparams, w, h)
    to, td = tgen(*tparams, w, h)
    assert td.shape == (h, w, 3) and td.dtype == torch.float32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_entry_points_default_to_the_gpu(monkeypatch):
    """flatten_model, scene_from_jax and Camera.raygen_params build on the
    GPU unless asked for the CPU: without CUDA the default raises instead
    of quietly returning CPU tensors."""
    from optixpathtracer_tpu_torch.scene import flatten_model, scene_from_jax
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, cam, lights = PRESETS["scene3_cornell"]()
    with pytest.raises(RuntimeError, match="CUDA"):
        flatten_model(model, lights)
    with pytest.raises(RuntimeError, match="CUDA"):
        cam.raygen_params(8, 8)
    scene = flatten_model(model, lights, device="cpu")
    assert scene.tri_v0.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_from_jax({k: v.numpy() for k, v in scene.leaves().items()})
    params = cam.raygen_params(8, 8, device="cpu")
    assert all(p.device.type == "cpu" for p in params)


def test_device_independent_rounding():
    """core.math's sqrt, cos_sin and exp give the correctly rounded float32
    (numpy's float64 result rounded once), so the CPU and the GPU agree:
    PyTorch's vectorised CPU torch.sqrt alone is one ulp off on some
    arguments, and float32 cos/sin/exp differ between libms."""
    from optixpathtracer_tpu_torch.core import math as tmath

    r = np.random.default_rng(5)
    x = r.uniform(0.0, 10.0, 200_000).astype(np.float32)
    theta = (r.uniform(0.0, 1.0, 200_000) * 2 * np.pi).astype(np.float32)
    np.testing.assert_array_equal(tmath.sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    cos, sin = tmath.cos_sin(torch.from_numpy(theta))
    t64 = theta.astype(np.float64)
    np.testing.assert_array_equal(cos.numpy(), np.cos(t64).astype(np.float32))
    np.testing.assert_array_equal(sin.numpy(), np.sin(t64).astype(np.float32))
    np.testing.assert_array_equal(
        tmath.exp(torch.from_numpy(-x)).numpy(),
        np.exp(-x.astype(np.float64)).astype(np.float32))
