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
    tris, boxes, n_live = dense_kernels.dense_arrays(scene)
    rays = dense_kernels._rays(torch.from_numpy(o), torch.from_numpy(d),
                               0.0, 100.0)
    counts = (dense_kernels.closest_kernel.launches,
              dense_kernels.any_kernel.launches)
    for kernel in (dense_kernels.closest_kernel, dense_kernels.any_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(tris, boxes, n_live, *rays)
        with pytest.raises(ValueError):
            kernel(tris, boxes[:, :-1], n_live, *rays)
        with pytest.raises(ValueError):
            kernel(tris.double(), boxes, n_live, *rays)
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


def _dense_scenes():
    """Cornell (34 triangles in one chunk), hall_small's cutout sub-scene
    (40) and two 128-triangle spheres (256 triangles: no padding slot),
    each with 768 rays from inside its bounds toward its triangles, dead
    rays (tmax = -1) and rays with tmax = tmin among them."""
    from optixpathtracer_tpu_torch.scene import flatten_model as tflatten
    from optixpathtracer_tpu_torch.scene import Material as TMaterial
    from optixpathtracer_tpu_torch.scene import Model as TModel
    from optixpathtracer_tpu_torch.scene import PointLight as TPointLight
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    from optixpathtracer_tpu_torch.scene.procedural import \
        uv_sphere as tsphere
    cornell = tflatten(*PRESETS["scene3_cornell"]()[::2], device="cpu")
    hall = tflatten(*PRESETS["hall_small"]()[::2], device="cpu").cutout_sub
    mat = TMaterial(mat_type="diffuse")
    spheres = tflatten(TModel(meshes=[tsphere(0.5, (0.0, 0.5, 0.0), 9, 8, mat),
                                      tsphere(0.5, (1.2, 0.5, 0.0), 5, 16,
                                              mat)]),
                       [TPointLight(np.array([2.0, 3.0, 1.0]), np.ones(3))],
                       device="cpu")
    rng = np.random.default_rng(11)
    out = []
    for name, scene in (("cornell", cornell), ("hall cutout", hall),
                        ("spheres", spheres)):
        v = scene.tri_v0[scene.tri_valid].numpy()
        lo, hi = v.min(axis=0), v.max(axis=0)
        o = rng.uniform(lo, hi, (768, 3)).astype(np.float32)
        target = v[rng.integers(0, len(v), 768)]
        d = target + rng.normal(0.0, 0.3, (768, 3)) - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        tmax = rng.uniform(0.5, 2.0 * float(np.abs(hi - lo).max()),
                           768).astype(np.float32)
        tmax[::9] = -1.0
        tmin = np.zeros(768, np.float32)
        tmin[5::13] = tmax[5::13]
        out.append((name, scene, [torch.from_numpy(x)
                                  for x in (o, d, tmin, tmax)]))
    return out


@pytest.fixture(scope="module")
def dense_scenes():
    return _dense_scenes()


def test_dense_n_live_and_padding(dense_scenes):
    """n_live is the last valid triangle + 1, and every slot from it on is
    padding: v0 = 1e10 and zero edges, which no ray can hit."""
    for name, scene, _ in dense_scenes:
        tris, boxes, n_live = dense_kernels.dense_arrays(scene)
        valid = scene.tri_valid.numpy()
        assert n_live == np.nonzero(valid)[0].max() + 1, name
        assert tris.shape[1] % 128 == 0 and n_live <= tris.shape[1]
        assert (tris[:3, n_live:] == 1e10).all(), name
        assert (tris[3:, n_live:] == 0).all(), name
    n_live = [dense_kernels.dense_arrays(s)[2] for _, s, _ in dense_scenes]
    assert n_live == [34, 40, 256]
    assert dense_kernels.dense_arrays(dense_scenes[2][1])[0].shape[1] == 256


def test_dense_sweep_of_live_triangles_is_the_full_sweep(dense_scenes):
    """The plain sweeps restricted to [0, n_live) give the full sweeps'
    (t, id) and blocked flags, bit for bit."""
    for name, scene, rays in dense_scenes:
        tris, _, n_live = dense_kernels.dense_arrays(scene)
        full = dense_kernels.closest_plain(tris, *rays)
        live = dense_kernels.closest_plain(tris[:, :n_live], *rays)
        assert (full[1] >= 0).any(), name
        for a, b in zip(full, live):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        blocked = dense_kernels.any_plain(tris, *rays)
        assert blocked.any() and not blocked.all(), name
        np.testing.assert_array_equal(
            blocked.numpy(),
            dense_kernels.any_plain(tris[:, :n_live], *rays).numpy())


def _hand_count_scene():
    """130 triangles in two chunks: id 0 a large triangle at z = 5 over the
    origin, ids 1-127 small ones far off the axis (x = 50, z = 20), id 128
    a large triangle at z = 8, id 129 a small one at x = 50, z = 8."""
    import types
    v0 = np.zeros((130, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    big = ((30.0, 0.0, 0.0), (0.0, 30.0, 0.0))
    small = ((0.1, 0.0, 0.0), (0.0, 0.1, 0.0))
    v0[0], (e1[0], e2[0]) = (-10.0, -10.0, 5.0), big
    for k in range(1, 128):
        v0[k], (e1[k], e2[k]) = (50.0, 0.1 * k, 20.0), small
    v0[128], (e1[128], e2[128]) = (-10.0, -10.0, 8.0), big
    v0[129], (e1[129], e2[129]) = (50.0, 0.0, 8.0), small
    return types.SimpleNamespace(
        tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
        tri_e2=torch.from_numpy(e2),
        tri_valid=torch.ones(130, dtype=torch.bool), cache={})


def test_needed_work_matches_a_hand_count():
    """One ray a 128-ray block (the rest dead), so each block's counts are
    one ray's (tests, and chunks tested):
    0: up the axis from the origin: closest tests chunk 0 (128), hits id 0
       at t = 5 and culls chunk 1 (box at t = 8); any stops at its first
       test, a blocker.
    1: the same ray with tmax = 4: both boxes lie beyond it: none.
    2: dead (tmax = -1): none.
    3: up the axis from z = 6, inside chunk 0's box: closest tests all of
       chunk 0 (no hit ahead) and chunk 1's two real triangles (130); any
       tests 128, then blocks on the first of chunk 1 (129).
    4: down the axis from the origin: both boxes behind it: none.
    Chunks tested: ray 0 one, ray 3 two (both kinds). Where the tests can
    end: the small triangles lie 50 off the axis, so u rules each out;
    the large ones (ids 0 and 128) go on to t."""
    scene = _hand_count_scene()
    tris, boxes, n_live = dense_kernels.dense_arrays(scene)
    assert (n_live, tris.shape[1]) == (130, 256)
    n = 5 * 128
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 2] = 1.0
    tmin = torch.zeros(n)
    tmax = torch.full((n,), -1.0)
    first = torch.arange(5) * 128
    tmax[first] = torch.tensor([100.0, 4.0, -1.0, 100.0, 100.0])
    o[first[3], 2] = 6.0
    d[first[4], 2] = -1.0
    closest = dense_kernels.needed_work("closest", tris, boxes, n_live, o, d,
                                        tmin, tmax)
    any_ = dense_kernels.needed_work("any", tris, boxes, n_live, o, d, tmin,
                                     tmax)
    assert closest.tests.tolist() == [128, 0, 0, 130, 0]
    assert any_.tests.tolist() == [1, 0, 0, 129, 0]
    assert (closest.chunks.tolist() == any_.chunks.tolist()
            == [1, 0, 0, 2, 0])
    none = [0, 0, 0]
    assert closest.exits.tolist() == [[127, 0, 1], none, none, [128, 0, 2],
                                      none]
    assert any_.exits.tolist() == [[0, 0, 1], none, none, [127, 0, 2], none]
    for work in (closest, any_):
        assert not work.below.any() and not work.above.any()
    t, ids = dense_kernels.closest_plain(tris, o, d, tmin, tmax)
    assert ids[first].tolist() == [0, -1, -1, 128, -1]
    blocked = dense_kernels.any_plain(tris, o, d, tmin, tmax)
    assert blocked[first].tolist() == [True, False, False, True, False]


def test_needed_work_counts_no_padding_or_dead_ray(dense_scenes):
    """On each scene: no block's tests exceed its live rays x n_live, nor
    its chunks the live chunks; dead rays add nothing (killing more rays
    never raises a block's count); occlusion needs no more than
    closest."""
    for name, scene, rays in dense_scenes:
        tris, boxes, n_live = dense_kernels.dense_arrays(scene)
        o, d, tmin, tmax = rays
        live = (tmax > tmin).view(-1, 128).sum(dim=1)
        closest, chunks, exits = dense_kernels.needed_work(
            "closest", tris, boxes, n_live, *rays)[:3]
        any_ = dense_kernels.needed_work("any", tris, boxes, n_live,
                                         *rays).tests
        assert torch.equal(exits.sum(dim=1), closest) and (exits >= 0).all()
        assert (closest <= live * n_live).all() and closest.sum() > 0, name
        assert (chunks <= -(-n_live // 128)).all() and chunks.sum() > 0
        assert (any_ <= closest).all(), name
        fewer = torch.where(torch.arange(len(tmax)) % 2 == 0, -1.0, tmax)
        assert (dense_kernels.needed_work("closest", tris, boxes, n_live, o,
                                          d, tmin, fewer)[0]
                <= closest).all()
