"""Port parity of the skip-link BVH engine (the CPU engine for scenes over
BRUTE_FORCE_MAX_TRIS triangles): `intersect/bvh_traverse.py` against the
JAX package's, on scenes carried across with `scene_from_jax`, so both
engines walk the same node arrays. Ids and hit masks equal, t/u/v within
rtol 1e-5."""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.intersect import bvh_traverse as jbvh
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import \
    scene_material_test as jmaterial_test
from optixpathtracer_tpu_torch.intersect import api, brute, bvh_traverse
from optixpathtracer_tpu_torch.scene import scene_from_jax

from test_walk_intersect import _make

torch.set_num_threads(1)


def jax_leaves(jscene):
    return {k: None if v is None else np.asarray(v)
            for k, v in jscene._asdict().items()}


def _scattered(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _spheres_case():
    """The multi-chunk spheres-over-floor scene, its 40x24 primaries and
    1024 scattered rays."""
    jscene, o, d = _make()
    o2, d2 = _scattered(1024, 5, (-3, 0.05, -3), (3, 4, 3))
    return (jscene, np.concatenate([np.asarray(o), o2]),
            np.concatenate([np.asarray(d), d2]))


def _diffuse_case():
    """The `diffuse` README scene cut to (6, 12) sphere segments (~4.3k
    triangles, over the brute threshold): rays from inside the room."""
    model, _, lights = jmaterial_test("diffuse", segments=(6, 12))
    jscene = jflatten(model, lights)
    o, d = _scattered(1536, 9, (-1.5, 0.2, -1.5), (3.0, 2.5, 1.5))
    return jscene, o, d


CASES = {"spheres": _spheres_case, "diffuse_6x12": _diffuse_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jscene, o, d = CASES[request.param]()
    return (request.param, jscene,
            scene_from_jax(jax_leaves(jscene), device="cpu"), o, d)


def _per_ray_tmax(n):
    tmax = np.full(n, 100.0, np.float32)
    tmax[::4] = 1.5
    tmax[::13] = -1.0
    return tmax


@pytest.mark.parametrize("tmax", ["100", "per-ray"])
def test_bvh_closest_matches_jax(case, tmax):
    _, jscene, scene, o, d = case
    tmax = (np.float32(100.0) if tmax == "100"
            else _per_ray_tmax(o.shape[0]))
    want = jbvh.intersect_closest(jscene, o, d, 0.0, tmax)
    got = bvh_traverse.intersect_closest(scene, torch.from_numpy(o),
                                         torch.from_numpy(d), 0.0,
                                         torch.as_tensor(tmax))
    hit = got.hit.numpy()
    assert 0 < hit.sum() < len(hit)
    np.testing.assert_array_equal(hit, np.asarray(want.hit))
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    np.testing.assert_array_equal(got.back_face.numpy(),
                                  np.asarray(want.back_face))
    # The JAX engine runs compiled (a vmapped while_loop has no op-by-op
    # mode) and XLA contracts its dot products into FMAs, which moves a
    # barycentric near 0, a difference of O(1) terms, by up to ~3e-6
    # absolute: u and v are held to atol 1e-5 (they lie in [0, 1]).
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # and the brute oracle finds the same triangles
    oracle = brute.intersect_closest(scene, torch.from_numpy(o),
                                     torch.from_numpy(d), 0.0,
                                     torch.as_tensor(tmax))
    np.testing.assert_array_equal(got.tri_id.numpy(), oracle.tri_id.numpy())


def test_bvh_any_matches_jax(case):
    _, jscene, scene, o, d = case
    tmax = np.linspace(0.2, 6.0, o.shape[0]).astype(np.float32)
    tmax[::13] = -1.0
    want = np.asarray(jbvh.intersect_any(jscene, o, d, 1e-3, tmax))
    got = bvh_traverse.intersect_any(scene, torch.from_numpy(o),
                                     torch.from_numpy(d), 1e-3,
                                     torch.from_numpy(tmax)).numpy()
    assert got.dtype == np.bool_ and 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)
    assert not got[::13].any()


def test_auto_routes_large_scenes_to_bvh_on_the_cpu(case):
    name, _, scene, o, d = case
    n = scene.tri_v0.shape[0]
    want = "bvh" if n > api.BRUTE_FORCE_MAX_TRIS else "brute"
    assert (name == "diffuse_6x12") == (want == "bvh")
    assert api._resolve("auto", scene, "cpu") == want
    assert api._resolve("auto:bounce", scene, torch.device("cpu")) == want
    got = api.intersect_closest(scene, torch.from_numpy(o),
                                torch.from_numpy(d))
    ref = api.intersect_closest(scene, torch.from_numpy(o),
                                torch.from_numpy(d), method="bvh")
    np.testing.assert_array_equal(got.tri_id.numpy(), ref.tri_id.numpy())


def test_bvh_is_cpu_only(case):
    _, _, scene, _, _ = case
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        bvh_traverse.intersect_closest(scene, o, o)


def _preset_triangles(name):
    """(v0, v1, v2) float32 of a port preset's meshes in model order, as
    the flatten hands them to the BVH builder."""
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    model, _, _ = PRESETS[name]()
    tris = [[], [], []]
    for mesh in model.meshes:
        m = mesh.model_matrix()
        pos = mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        idx = mesh.indices.astype(np.int64)
        for k in range(3):
            tris[k].append(pos[idx[:, k]])
    return [np.concatenate(t).astype(np.float32) for t in tris]


def test_native_builder_is_the_ports_own_source():
    import os

    import optixpathtracer_tpu_torch
    from optixpathtracer_tpu_torch import native
    pkg = os.path.dirname(os.path.abspath(optixpathtracer_tpu_torch.__file__))
    assert os.path.commonpath([pkg, os.path.abspath(native.SOURCE)]) == pkg
    assert os.path.isfile(native.SOURCE)
    assert native.native_available()  # no fallback to the numpy builder


@pytest.mark.parametrize("preset", ["scene3_cornell", "diffuse"])
def test_native_builder_matches_the_reference(preset):
    """The port's build of its own bvh_builder.cpp gives the reference's
    build of its source, array for array: the same triangle order, so the
    same triangle ids in both packages."""
    from optixpathtracer_tpu import native as jnative
    from optixpathtracer_tpu_torch import native
    assert jnative.native_available() and native.native_available()
    v0, v1, v2 = _preset_triangles(preset)
    got = native.build_bvh_native(v0, v1, v2)
    want = jnative.build_bvh_native(v0, v1, v2)
    assert got is not None and want is not None
    assert len(got.tri_order) == len(v0) > 0
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
