"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips (and counts no pass) where there is no
CUDA device. On the machine with the GPU, which has no JAX, run them
without tests/conftest.py (it sets JAX up):
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`.
The plain versions are the reference here; the CPU tests
(tests/test_torch_intersect.py) hold them against the JAX package."""
import contextlib
import functools

import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.camera import Camera
from optixpathtracer_tpu_torch.camera.camera import generate_rays
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
from optixpathtracer_tpu_torch.scene import (Material, Model, PointLight,
                                             flatten_model)
from optixpathtracer_tpu_torch.scene.procedural import (PRESETS, quad,
                                                        scene_material_test,
                                                        uv_sphere)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the GPU)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_kernels():
    """Route the CUDA path of the dense, walk and packet engines to the
    plain versions."""
    saved = (dk.closest_kernel, dk.any_kernel, wk.candidates_kernel,
             wk.closest_kernel, wk.any_kernel, pk.packet_closest_kernel,
             pk.packet_any_kernel)
    dk.closest_kernel = lambda tris, boxes, *rays: dk.closest_plain(tris,
                                                                    *rays)
    dk.any_kernel = lambda tris, boxes, *rays: dk.any_plain(tris, *rays)
    wk.candidates_kernel = wk.candidates_plain
    wk.closest_kernel = (lambda tris, boxes, cand, tnear, count, *rays:
                         wk.closest_plain(tris, cand, count, *rays))
    wk.any_kernel = (lambda tris, boxes, cand, count, *rays:
                     wk.any_plain(tris, cand, count, *rays))
    pk.packet_closest_kernel = functools.partial(pk.plain_launch,
                                                 pk.packet_closest_plain)
    pk.packet_any_kernel = functools.partial(pk.plain_launch,
                                             pk.packet_any_plain)
    try:
        yield
    finally:
        (dk.closest_kernel, dk.any_kernel, wk.candidates_kernel,
         wk.closest_kernel, wk.any_kernel, pk.packet_closest_kernel,
         pk.packet_any_kernel) = saved


def _sphere_floor_rays(device):
    sphere = uv_sphere(0.5, (0.0, 0.5, 0.0), 10, 20,
                       Material(mat_type="diffuse"))
    floor = quad((-5.0, 0.0, -5.0), (0.0, 0.0, 10.0), (10.0, 0.0, 0.0),
                 Material(mat_type="diffuse"))
    scene = flatten_model(Model(meshes=[sphere, floor]),
                          [PointLight(np.array([2.0, 3.0, 1.0]), np.ones(3))],
                          device=device)
    cam = Camera(position=np.array([3.0, 1.0, 0.0]),
                 rotation=np.array([10.0, 180.0, 0.0]))
    o, d = generate_rays(*cam.raygen_params(320, 240, device), 320, 240)
    return scene, o.reshape(-1, 3).contiguous(), d.reshape(-1, 3)


def test_kernels_match_plain_on_sphere_scene(cuda):
    scene, o, d = _sphere_floor_rays(cuda)
    tris, boxes = dk.dense_arrays(scene)
    r = o.shape[0]
    tmin = torch.zeros(r, device=cuda)
    for tmax_val in (100.0, 1.0):
        tmax = torch.full((r,), tmax_val, device=cuda)
        kt, ki = dk.closest_kernel(tris, boxes, o, d, tmin, tmax)
        pt, pi = dk.closest_plain(tris, o, d, tmin, tmax)
        torch.cuda.synchronize()
        if tmax_val == 100.0:  # nothing lies within 1.0 of this camera
            assert (ki >= 0).any() and (ki < 0).any()
        assert torch.equal(ki, pi)
        assert torch.equal(kt, pt)
        swept, tests = dk.closest_kernel.swept, dk.closest_kernel.tests
        assert (swept <= boxes.shape[1]).all()
        assert (tests <= swept * dk.BLOCK_RAYS * dk.TRI_CHUNK).all()
    tmax = torch.full((r,), 3.0, device=cuda)
    tmax[::17] = -1.0
    kb = dk.any_kernel(tris, boxes, o, d, tmin, tmax)
    pb = dk.any_plain(tris, o, d, tmin, tmax)
    assert kb.any() and not kb.all()
    assert torch.equal(kb, pb)
    assert not kb[::17].any()


def test_launch_errors_raise(cuda):
    scene, o, d = _sphere_floor_rays(cuda)
    tris, boxes = dk.dense_arrays(scene)
    tmin = torch.zeros(o.shape[0], device=cuda)
    with pytest.raises(ValueError):  # mixed devices are refused
        dk.closest_kernel(tris, boxes, o.cpu(), d, tmin, tmin)
    before = dk.closest_kernel.launches
    dk.intersect_closest_raw(scene, o, d, 0.0, 100.0)
    assert dk.closest_kernel.launches == before + 1


def _walk_scene_rays(device, max_walk_chunks=None, size=(320, 240)):
    """The `diffuse` README scene cut to (6, 12) sphere segments (34 walk
    chunks of 128, or 256-triangle chunks under a smaller MAX_WALK_CHUNKS)
    and its camera's primary rays."""
    from optixpathtracer_tpu_torch.scene import flatten as flatten_mod
    model, camera, lights = scene_material_test("diffuse", segments=(6, 12))
    saved = flatten_mod.MAX_WALK_CHUNKS
    if max_walk_chunks is not None:
        flatten_mod.MAX_WALK_CHUNKS = max_walk_chunks
    try:
        scene = flatten_model(model, lights, device=device)
    finally:
        flatten_mod.MAX_WALK_CHUNKS = saved
    w, h = size
    o, d = generate_rays(*camera.raygen_params(w, h, device), w, h)
    return scene, o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def _check_walk_kernels(scene, o, d, tmin, tmax, block_rays):
    """Each walk kernel against its plain version on one query."""
    perm = wk._coherence_perm(scene, o, d)
    rays = [x[perm].contiguous() for x in (o, d, tmin, tmax)]
    boxes = wk._chunk_boxes(scene)
    entry = wk.candidates_kernel(boxes, *rays, block_rays)
    assert torch.equal(entry, wk.candidates_plain(boxes, *rays, block_rays))
    cand, tnear, count = wk.sort_candidates(entry)
    kt, ki = wk.closest_kernel(scene.walk_tris, boxes, cand, tnear, count,
                               *rays, block_rays)
    pt, pi = wk.closest_plain(scene.walk_tris, cand, count, *rays,
                              block_rays)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    swept, tests = wk.closest_kernel.swept, wk.closest_kernel.tests
    assert swept.shape == tests.shape == count.shape
    assert (swept <= count).all() and tests.sum() > 0
    assert (tests <= swept * block_rays * scene.walk_chunk).all()
    kb = wk.any_kernel(scene.walk_tris, boxes, cand, count, *rays,
                       block_rays)
    pb = wk.any_plain(scene.walk_tris, cand, count, *rays, block_rays)
    assert torch.equal(kb, pb)
    assert not kb[rays[3] < 0].any()  # dead lanes are never blocked
    return ki, kb


@pytest.mark.parametrize("block_rays", [256, 1024])
def test_walk_kernels_match_plain(cuda, block_rays):
    scene, o, d = _walk_scene_rays(cuda)
    assert scene.walk_tris.shape[0] >= 8 and scene.walk_chunk == 128
    r = o.shape[0]
    tmin = torch.zeros(r, device=cuda)
    for tmax_val in (100.0, 1.0):
        tmax = torch.full((r,), tmax_val, device=cuda)
        tmax[::11] = -1.0  # dead lanes
        ki, kb = _check_walk_kernels(scene, o, d, tmin, tmax, block_rays)
        if tmax_val == 100.0:
            assert (ki >= 0).any() and (ki < 0).any()
            assert kb.any() and not kb.all()
    # and the engine, sort and unsort included, against brute
    hit = wk.intersect_closest(scene, o, d, 0.0, 100.0, block_rays)
    from optixpathtracer_tpu_torch.intersect import brute
    want = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    assert torch.equal(hit.tri_id, want.tri_id)


def test_walk_kernels_chunk_256(cuda):
    scene, o, d = _walk_scene_rays(cuda, max_walk_chunks=20)
    assert scene.walk_chunk == 256
    r = o.shape[0]
    _check_walk_kernels(scene, o, d, torch.zeros(r, device=cuda),
                        torch.full((r,), 100.0, device=cuda), 256)


def test_walk_launch_errors_raise(cuda):
    scene, o, d = _walk_scene_rays(cuda, size=(64, 48))
    before = (wk.candidates_kernel.launches, wk.closest_kernel.launches,
              wk.any_kernel.launches)
    wk.intersect_closest_raw(scene, o, d, 0.0, 100.0)
    wk.intersect_any(scene, o, d, 0.0, 100.0)
    assert (wk.candidates_kernel.launches, wk.closest_kernel.launches,
            wk.any_kernel.launches) == (before[0] + 2, before[1] + 1,
                                        before[2] + 1)
    boxes = wk._chunk_boxes(scene)
    tmin = torch.zeros(o.shape[0], device=cuda)
    with pytest.raises(ValueError):  # mixed devices are refused
        wk.candidates_kernel(boxes, o.cpu(), d, tmin, tmin)


def _check_packet_kernels(scene, o, d, tmin, tmax, block_rays):
    """Both packet kernels against the plain words and sweeps on one
    query: words bit-identical, ids, t and blocked flags identical."""
    perm = wk._coherence_perm(scene, o, d)
    rays = [x[perm].contiguous() for x in (o, d, tmin, tmax)]
    cand, tnear, count = wk.sort_candidates(
        wk.candidates_kernel(wk._chunk_boxes(scene), *rays, block_rays))
    args = (scene.walk_tris, scene.walk_sub_box, cand, tnear, count, *rays,
            block_rays)
    words = pk.packet_words_plain(scene.walk_sub_box, cand, tnear, *rays,
                                  scene.walk_chunk, block_rays)[0]
    kt, ki = pk.packet_closest_kernel(*args, with_words=True)
    pt, pi = pk.packet_closest_plain(scene.walk_tris, cand, words, *rays,
                                     block_rays)
    torch.cuda.synchronize()
    assert torch.equal(pk.packet_closest_kernel.words, words)
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    k = pk.packet_closest_kernel
    assert k.swept.shape == k.tests.shape == k.slabs.shape == count.shape
    assert (k.tests <= k.swept * 8 * pk.SUB).all() and k.tests.sum() > 0
    kb = pk.packet_any_kernel(*args, with_words=True)
    pb = pk.packet_any_plain(scene.walk_tris, cand, words, *rays, block_rays)
    assert torch.equal(pk.packet_any_kernel.words, words)
    assert torch.equal(kb, pb)
    assert not kb[rays[3] < 0].any()
    return ki, kb


@pytest.mark.parametrize("block_rays,max_walk_chunks", [
    (256, None), (1024, None), (256, 20)])
def test_packet_kernels_match_plain(cuda, block_rays, max_walk_chunks):
    """At chunk 128 and (MAX_WALK_CHUNKS = 20) at chunk 256, on primaries
    and on scattered rays from the hit points, with dead lanes."""
    scene, o, d = _walk_scene_rays(cuda, max_walk_chunks)
    assert scene.walk_chunk == (128 if max_walk_chunks is None else 256)
    r = o.shape[0]
    tmin = torch.zeros(r, device=cuda)
    tmax = torch.full((r,), 100.0, device=cuda)
    tmax[::11] = -1.0
    ki, kb = _check_packet_kernels(scene, o, d, tmin, tmax, block_rays)
    assert (ki >= 0).any() and (ki < 0).any() and kb.any()
    hit = wk.intersect_closest(scene, o, d, 0.0, 100.0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    dirs = torch.randn((r, 3), generator=gen).to(cuda)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    origins = (o + hit.t[:, None] * d + 1e-3 * dirs).contiguous()
    tmax = torch.where(hit.hit, 5.0, -1.0)
    _check_packet_kernels(scene, origins, dirs.contiguous(), tmin, tmax,
                          block_rays)
    from optixpathtracer_tpu_torch.intersect import brute
    got = pk.intersect_closest(scene, origins, dirs, 0.0, tmax, block_rays)
    want = brute.intersect_closest(scene, origins, dirs, 0.0, tmax)
    assert torch.equal(got.tri_id, want.tri_id)


def test_hall_small_packet_render_matches_plain(cuda):
    """hall_small (textured, cutout) rendered with the packet engine on
    both sub-scenes, against the plain versions by the engine-golden
    criterion."""
    model, camera, lights = PRESETS["hall_small"]()
    scene = flatten_model(model, lights, device=cuda)
    before = (pk.packet_closest_kernel.launches, pk.packet_any_kernel.launches)
    img = path.render(scene, camera, 32, 32, spp=1, max_bounces=2,
                      intersect_method="packet").cpu().numpy()
    after = (pk.packet_closest_kernel.launches, pk.packet_any_kernel.launches)
    assert after[0] > before[0] and after[1] > before[1]
    with plain_kernels():
        want = path.render(scene, camera, 32, 32, spp=1, max_bounces=2,
                           intersect_method="packet").cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.005
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


@pytest.mark.parametrize("name,size,spp,bounces", [
    ("scene3_cornell", 32, 1, 2),
    ("diffuse_6x12", 16, 1, 3),
    ("layered_6x12", 16, 1, 2),
])
def test_render_kernels_match_plain(cuda, name, size, spp, bounces):
    """Cornell (1 chunk) renders through the dense kernels, the material
    scenes (34 chunks) through the walk kernels; either way the image
    equals the plain versions' by the engine-golden criterion."""
    if name == "scene3_cornell":
        model, camera, lights = PRESETS[name]()
    else:
        model, camera, lights = scene_material_test(name.split("_")[0],
                                                    segments=(6, 12))
    scene = flatten_model(model, lights, device=cuda)
    wrappers = ([dk.closest_kernel, dk.any_kernel] if name == "scene3_cornell"
                else [wk.candidates_kernel, wk.closest_kernel, wk.any_kernel])
    per_query = [1, 1] if name == "scene3_cornell" else [2, 1, 1]
    before = [w.launches for w in wrappers]
    img = path.render(scene, camera, size, size, spp=spp,
                      max_bounces=bounces).cpu().numpy()
    for w, n0, k in zip(wrappers, before, per_query):
        assert w.launches - n0 == k * spp * bounces
    with plain_kernels():
        want = path.render(scene, camera, size, size, spp=spp,
                           max_bounces=bounces).cpu().numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.005
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
