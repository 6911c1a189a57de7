"""Port parity of intersection: the dense engine's plain PyTorch version
(what the CUDA kernels compute, run here on the CPU) against the JAX
package's Pallas kernels in interpret mode and its brute-force oracle, on
the sphere-and-floor scene of tests/test_pallas_intersect.py; the port's
brute oracle and `_refine` against the reference's."""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optixpathtracer_tpu.camera import Camera as JCamera
from optixpathtracer_tpu.camera.camera import generate_rays
from optixpathtracer_tpu.intersect import api as japi
from optixpathtracer_tpu.intersect import brute as jbrute
from optixpathtracer_tpu.intersect import pallas_kernels
from optixpathtracer_tpu.scene import Material, Model, PointLight
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import quad, uv_sphere
from optixpathtracer_tpu_torch.intersect import api, brute, dense_kernels
from optixpathtracer_tpu_torch.intersect.types import Hit
from optixpathtracer_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes_and_rays():
    sphere = uv_sphere(0.5, (0.0, 0.5, 0.0), 10, 20,
                       Material(mat_type="diffuse"))
    floor = quad((-5.0, 0.0, -5.0), (0.0, 0.0, 10.0), (10.0, 0.0, 0.0),
                 Material(mat_type="diffuse"))
    jscene = jflatten(Model(meshes=[sphere, floor]),
                      [PointLight(np.array([2.0, 3.0, 1.0]), np.ones(3))])
    cam = JCamera(position=np.array([3.0, 1.0, 0.0]),
                  rotation=np.array([10.0, 180.0, 0.0]))
    pos, iv, ip = cam.raygen_params(32, 24)
    o, d = generate_rays(pos, iv, ip, 32, 24)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    # a second wavefront of scattered rays from points above the floor, so
    # misses, grazing hits and the sphere's back faces all occur
    rng = np.random.default_rng(7)
    o2 = rng.uniform([-2, 0.05, -2], [2, 2, 2], (512, 3)).astype(np.float32)
    d2 = rng.normal(size=(512, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([o, o2])
    d = np.concatenate([d, d2])
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in jscene._asdict().items()}
    return jscene, scene_from_jax(leaves, device="cpu"), o, d


def _jax_closest(jscene, o, d, tmax):
    with pltpu.force_tpu_interpret_mode():
        got = pallas_kernels.intersect_closest(jscene, o, d, 0.0, tmax)
    return {k: np.asarray(v) for k, v in got._asdict().items()}


@pytest.mark.parametrize("tmax", [100.0, 1.0])
def test_dense_plain_matches_pallas_and_brute(scenes_and_rays, tmax):
    jscene, scene, o, d = scenes_and_rays
    want = _jax_closest(jscene, o, d, tmax)
    oracle = jbrute.intersect_closest(jscene, o, d, 0.0, tmax)
    got = dense_kernels.intersect_closest(scene, torch.from_numpy(o),
                                          torch.from_numpy(d), 0.0, tmax)
    hit = got.hit.numpy()
    assert 0 < hit.sum() < len(hit)
    for ref in (want, {k: np.asarray(v) for k, v in oracle._asdict().items()}):
        np.testing.assert_array_equal(hit, ref["hit"])
        np.testing.assert_array_equal(got.tri_id.numpy(), ref["tri_id"])
        np.testing.assert_allclose(got.t.numpy()[hit], ref["t"][hit],
                                   rtol=1e-5)
    # misses report tmax, as the reference engines do
    np.testing.assert_array_equal(got.t.numpy()[~hit], np.float32(tmax))
    assert (got.t.numpy()[hit] < tmax).all()


def test_dense_plain_any_matches_pallas_and_brute(scenes_and_rays):
    jscene, scene, o, d = scenes_and_rays
    tmax = np.linspace(0.1, 6.0, len(o)).astype(np.float32)
    tmax[::17] = -1.0  # dead lanes never block
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_kernels.intersect_any(jscene, o, d, 0.0,
                                                       tmax))
    oracle = np.asarray(jbrute.intersect_any(jscene, o, d, 0.0, tmax))
    got = dense_kernels.intersect_any(scene, torch.from_numpy(o),
                                      torch.from_numpy(d), 0.0,
                                      torch.from_numpy(tmax)).numpy()
    assert got.dtype == np.bool_
    assert 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert not got[::17].any()


def test_dense_raw_miss_convention(scenes_and_rays):
    _, scene, o, d = scenes_and_rays
    t, tri_id = dense_kernels.intersect_closest_raw(
        scene, torch.from_numpy(o), torch.from_numpy(d), 0.0, 100.0)
    miss = tri_id.numpy() < 0
    assert miss.any()
    np.testing.assert_array_equal(t.numpy()[miss], np.float32(3.4e38))
    assert tri_id.dtype == torch.int32


def test_plain_sweep_steps_do_not_change_result(scenes_and_rays,
                                                monkeypatch):
    """Many small steps (ray and triangle chunks) give the same hits as one
    step: ties across chunk boundaries still go to the lowest id."""
    _, scene, o, d = scenes_and_rays
    args = (scene, torch.from_numpy(o), torch.from_numpy(d), 0.0, 100.0)
    one = dense_kernels.intersect_closest_raw(*args)
    monkeypatch.setattr(dense_kernels, "PLAIN_PAIRS", 128 * 64)
    many = dense_kernels.intersect_closest_raw(*args)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(
        scenes_and_rays):
    """The CUDA wrappers check their inputs before any pointer reaches a
    kernel: CPU tensors (host pointers), wrong dtypes and wrong shapes are
    refused, and nothing is launched or counted."""
    _, scene, o, d = scenes_and_rays
    tris, boxes = dense_kernels.dense_arrays(scene)
    rays = dense_kernels._rays(torch.from_numpy(o), torch.from_numpy(d),
                               0.0, 100.0)
    counts = (dense_kernels.closest_kernel.launches,
              dense_kernels.any_kernel.launches)
    for kernel in (dense_kernels.closest_kernel, dense_kernels.any_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(tris, boxes, *rays)
        with pytest.raises(ValueError):
            kernel(tris, boxes[:, :-1], *rays)
        with pytest.raises(ValueError):
            kernel(tris.double(), boxes, *rays)
    assert counts == (dense_kernels.closest_kernel.launches,
                      dense_kernels.any_kernel.launches)


def test_brute_matches_reference(scenes_and_rays):
    jscene, scene, o, d = scenes_and_rays
    want = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    got = brute.intersect_closest(scene, torch.from_numpy(o),
                                  torch.from_numpy(d), 0.0, 100.0)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    np.testing.assert_array_equal(got.back_face.numpy(),
                                  np.asarray(want.back_face))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit],
                                   np.asarray(getattr(want, k))[hit],
                                   rtol=1e-5, atol=1e-6)
    tmax = np.full(len(o), 2.0, np.float32)
    np.testing.assert_array_equal(
        brute.intersect_any(scene, torch.from_numpy(o), torch.from_numpy(d),
                            0.0, torch.from_numpy(tmax)).numpy(),
        np.asarray(jbrute.intersect_any(jscene, o, d, 0.0, tmax)))


def test_refine_matches_reference(scenes_and_rays):
    jscene, scene, o, d = scenes_and_rays
    raw = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    tmax = np.full(len(o), 100.0, np.float32)
    want = japi._refine(jscene, o, d, raw, tmax)
    traw = Hit(*[torch.from_numpy(np.array(x)) for x in raw])
    got = api._refine(scene, torch.from_numpy(o), torch.from_numpy(d), traw,
                      torch.from_numpy(tmax))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.back_face.numpy(),
                                  np.asarray(want.back_face))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5)


def test_api_routes_and_detaches(scenes_and_rays):
    jscene, scene, o, d = scenes_and_rays
    assert api._resolve("auto", scene, "cpu") == "brute"  # 218 triangles
    assert api._resolve("auto:bounce", scene, "cuda") == "pallas"
    assert api._resolve("auto", scene, torch.device("cuda", 0)) == "pallas"
    assert api._resolve("brute", scene, "cuda") == "brute"
    packet = api.intersect_closest(scene, torch.from_numpy(o),
                                   torch.from_numpy(d), method="packet")
    oracle = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    np.testing.assert_array_equal(packet.tri_id.numpy(),
                                  np.asarray(oracle.tri_id))
    with pytest.raises(ValueError, match="unknown"):
        api.intersect_closest(scene, torch.from_numpy(o), torch.from_numpy(d),
                              method="optix")
    # gradients reach ray origins through _refine, not through the engine
    ot = torch.from_numpy(o).requires_grad_(True)
    got = api.intersect_closest(scene, ot, torch.from_numpy(d), 0.0, 100.0,
                                method="pallas")
    got.t[got.hit].sum().backward()
    assert torch.isfinite(ot.grad).all() and ot.grad.abs().sum() > 0
    want = japi.intersect_closest(jscene, o, d, 0.0, 100.0, method="brute")
    np.testing.assert_array_equal(got.tri_id.numpy(),
                                  np.asarray(want.tri_id))
    np.testing.assert_allclose(got.t.detach().numpy(), np.asarray(want.t),
                               rtol=1e-5)
