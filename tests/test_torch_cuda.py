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

from optixpathtracer_tpu_torch.bsdf import dispatch
from optixpathtracer_tpu_torch.bsdf import glossy_diffuse as gd
from optixpathtracer_tpu_torch.bsdf import kernels as bk
from optixpathtracer_tpu_torch.camera import Camera
from optixpathtracer_tpu_torch.camera.camera import generate_rays
from optixpathtracer_tpu_torch.diff import param_gradients
from optixpathtracer_tpu_torch.integrate import cutout, path
from optixpathtracer_tpu_torch.intersect import dense_kernels as dk
from optixpathtracer_tpu_torch.intersect import packet_kernels as pk
from optixpathtracer_tpu_torch.intersect import walk_kernels as wk
from optixpathtracer_tpu_torch.intersect.types import Hit
from optixpathtracer_tpu_torch.scene import (Material, Model, PointLight,
                                             flatten_model)
from optixpathtracer_tpu_torch.scene.procedural import (PRESETS, quad,
                                                        scene_material_test,
                                                        uv_sphere)

from cutout_stack import LANES, TIE_LANE, stack_model, stack_rays

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the GPU)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_bsdf():
    """Route the CUDA path of the BSDF dispatch to the plain dispatch."""
    saved = (dispatch.f_kernel, dispatch.sample_kernel)
    dispatch.f_kernel = dispatch.f_plain
    dispatch.sample_kernel = dispatch.sample_plain
    try:
        yield
    finally:
        dispatch.f_kernel, dispatch.sample_kernel = saved


@contextlib.contextmanager
def plain_chains():
    """Route the alpha-cutout chains to the plain chain on every device."""
    saved = cutout.chain_kernel_route
    cutout.chain_kernel_route = lambda *args: False
    try:
        yield
    finally:
        cutout.chain_kernel_route = saved


@contextlib.contextmanager
def plain_kernels():
    """Route the CUDA path of the dense, walk and packet engines, of the
    cutout chains and of the BSDF dispatch to the plain versions."""
    saved = (dk.closest_kernel, dk.any_kernel, wk.candidates_kernel,
             wk.closest_kernel, wk.any_kernel, pk.packet_closest_kernel,
             pk.packet_any_kernel)
    dk.closest_kernel = (lambda tris, boxes, n_live, *rays:
                         dk.closest_plain(tris, *rays))
    dk.any_kernel = (lambda tris, boxes, n_live, *rays:
                     dk.any_plain(tris, *rays))
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
        with plain_bsdf(), plain_chains():
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


def _check_dense_kernels(tris, boxes, n_live, rays):
    """Both dense kernels against the plain versions on one query: t, ids
    and blocked flags identical; each 128-ray block's tests and chunks
    swept exactly the needed-work counts of `dk.needed_work` (so never
    more than its live rays x n_live tests, nor the live chunks). Returns
    (ids, blocked)."""
    tmin, tmax = rays[2], rays[3]
    kt, ki = dk.closest_kernel(tris, boxes, n_live, *rays)
    pt, pi = dk.closest_plain(tris, *rays)
    kb = dk.any_kernel(tris, boxes, n_live, *rays)
    pb = dk.any_plain(tris, *rays)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    assert torch.equal(kb, pb)
    assert not kb[tmax <= tmin].any()  # dead rays are never blocked
    n_blocks = -(-tmax.shape[0] // dk.BLOCK_RAYS)
    live = torch.zeros(n_blocks * dk.BLOCK_RAYS, dtype=torch.long,
                       device=tmax.device)
    live[:tmax.shape[0]] = tmax > tmin
    live = live.view(n_blocks, -1).sum(dim=1)
    live_chunks = -(-n_live // dk.TRI_CHUNK)
    for kind, k in (("closest", dk.closest_kernel), ("any", dk.any_kernel)):
        assert k.swept.shape == k.tests.shape == (n_blocks,)
        need, chunks = dk.needed_work(kind, tris, boxes, n_live, *rays)[:2]
        assert torch.equal(k.tests.long(), need), kind
        assert torch.equal(k.swept.long(), chunks), kind
        assert (need <= live * n_live).all()
        assert (chunks <= live_chunks).all() and k.tests.sum() > 0
    return ki, kb


def test_kernels_match_plain_on_sphere_scene(cuda):
    scene, o, d = _sphere_floor_rays(cuda)
    tris, boxes, n_live = dk.dense_arrays(scene)
    r = o.shape[0]
    tmin = torch.zeros(r, device=cuda)
    for tmax_val in (100.0, 1.0, 3.0):
        tmax = torch.full((r,), tmax_val, device=cuda)
        if tmax_val == 3.0:
            tmax[::17] = -1.0
        ki, kb = _check_dense_kernels(tris, boxes, n_live, (o, d, tmin, tmax))
        if tmax_val == 100.0:  # nothing lies within 1.0 of this camera
            assert (ki >= 0).any() and (ki < 0).any()
        if tmax_val == 3.0:
            assert kb.any() and not kb.all()


def _scattered(o, d, hit_t, seed):
    """Rays from just off the hit points of (o, d) in random directions,
    tmax 5 from a hit, dead (tmax = -1) from a miss, as a bounce's
    wavefront; every third ray of those also dead, every fifth given
    tmax = tmin (live in no test), so dead lanes sit in live warps."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dirs = torch.randn(o.shape, generator=gen).to(o.device)
    dirs = (dirs / dirs.norm(dim=1, keepdim=True)).contiguous()
    hit = hit_t < 1e30
    origins = (o + torch.where(hit, hit_t, 0.0)[:, None] * d
               + 1e-3 * dirs).contiguous()
    tmax = torch.where(hit, 5.0, -1.0)
    tmax[::3] = -1.0
    tmin = torch.zeros_like(tmax)
    tmin[1::5] = 0.5
    tmax[1::5] = 0.5
    return origins, dirs, tmin, tmax


def _sphere_scene(device, rings, segments):
    mat = Material(mat_type="diffuse")
    floor = quad((-5.0, 0.0, -5.0), (0.0, 0.0, 10.0), (10.0, 0.0, 0.0), mat)
    return flatten_model(Model(meshes=[uv_sphere(0.5, (0.0, 0.5, 0.0), rings,
                                                 segments, mat), floor]),
                         [PointLight(np.array([2.0, 3.0, 1.0]), np.ones(3))],
                         device=device)


@pytest.mark.parametrize("rings,segments,n_chunks", [(5, 8, 1), (26, 16, 7)])
def test_dense_kernels_dead_lanes_and_ragged_end(cuda, rings, segments,
                                                 n_chunks):
    """A 1-chunk and a 7-chunk scene (a sphere on a floor; the last chunk
    part padding): primaries cut 13 rays short of a block (the last block
    is part padding), with dead lanes in live warps, and a scattered
    wavefront from their hit points."""
    scene = _sphere_scene(cuda, rings, segments)
    tris, boxes, n_live = dk.dense_arrays(scene)
    assert boxes.shape[1] == n_chunks and n_live % dk.TRI_CHUNK != 0
    cam = Camera(position=np.array([3.0, 1.0, 0.0]),
                 rotation=np.array([10.0, 180.0, 0.0]))
    o, d = generate_rays(*cam.raygen_params(160, 120, cuda), 160, 120)
    o = o.reshape(-1, 3)[:-13].contiguous()
    d = d.reshape(-1, 3)[:-13].contiguous()
    r = o.shape[0]
    tmax = torch.full((r,), 100.0, device=cuda)
    tmax[::7] = -1.0
    rays = (o, d, torch.zeros(r, device=cuda), tmax)
    ki, _ = _check_dense_kernels(tris, boxes, n_live, rays)
    assert (ki >= 0).any() and (ki < 0).any()
    kt = dk.closest_kernel(tris, boxes, n_live, o, d, rays[2],
                           torch.full((r,), 100.0, device=cuda))[0]
    _, kb = _check_dense_kernels(tris, boxes, n_live,
                                 _scattered(o, d, kt, seed=1))
    assert kb.any() and not kb.all()


def test_dense_ties_across_chunks(cuda):
    """Two coincident triangles in chunks 0 and 2 (ids 100 and 300), with
    chunk 1 (small triangles behind them) between: both kernels agree with
    the plain versions, and closest returns the lower id, 100."""
    import types
    n = 301
    v0 = np.zeros((n, 3), np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)
    for k in range(n):  # small triangles behind the pair, off the axis
        v0[k], e1[k], e2[k] = (3.0, 0.01 * k, 12.0), (0.1, 0, 0), (0, 0.1, 0)
    for k in (100, 300):
        v0[k], e1[k], e2[k] = (-4.0, -4.0, 10.0), (8.0, 0, 0), (0, 8.0, 0)
    scene = types.SimpleNamespace(
        **{k: torch.tensor(x, device=cuda) for k, x in
           (("tri_v0", v0), ("tri_e1", e1), ("tri_e2", e2))},
        tri_valid=torch.ones(n, dtype=torch.bool, device=cuda), cache={})
    tris, boxes, n_live = dk.dense_arrays(scene)
    assert (boxes.shape[1], n_live) == (3, 301)
    rng = np.random.default_rng(5)
    m = 3 * 128 - 5
    target = np.concatenate([rng.uniform(-2.0, -0.2, (m, 2)),
                             np.full((m, 1), 10.0)], axis=1)
    o = rng.normal(0.0, 0.01, (m, 3))
    dirs = target - o
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tmax = np.full(m, 100.0)
    tmax[::4] = -1.0
    rays = [torch.tensor(x, dtype=torch.float32, device=cuda).contiguous()
            for x in (o, dirs, np.zeros(m), tmax)]
    ki, kb = _check_dense_kernels(tris, boxes, n_live, rays)
    live = rays[3] > 0
    assert (ki[live] == 100).all() and kb[live].all()


def test_dense_kernels_many_tiles_through_pallas(cuda):
    """The full `diffuse` scene (149 chunks: 19 tiles of 8) through the
    dense kernels, directly and through method "pallas", against the
    plain versions: the (t, id) or blocked flag kept between tiles."""
    from optixpathtracer_tpu_torch.intersect import api
    scene, o, d = _walk_scene_rays(cuda, segments=None, size=(96, 64))
    tris, boxes, n_live = dk.dense_arrays(scene)
    assert boxes.shape[1] == 149
    r = o.shape[0]
    tmax = torch.full((r,), 100.0, device=cuda)
    tmax[::11] = -1.0
    rays = (o, d, torch.zeros(r, device=cuda), tmax)
    ki, _ = _check_dense_kernels(tris, boxes, n_live, rays)
    assert (ki >= 0).any()
    kt = dk.closest_kernel(tris, boxes, n_live, *rays)[0]
    _check_dense_kernels(tris, boxes, n_live, _scattered(o, d, kt, seed=2))
    before = dk.closest_kernel.launches
    got = api.intersect_closest(scene, o, d, 0.0, 100.0, method="pallas")
    assert dk.closest_kernel.launches == before + 1
    with plain_kernels():
        want = api.intersect_closest(scene, o, d, 0.0, 100.0,
                                     method="pallas")
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.t, want.t)


def test_launch_errors_raise(cuda):
    scene, o, d = _sphere_floor_rays(cuda)
    tris, boxes, n_live = dk.dense_arrays(scene)
    tmin = torch.zeros(o.shape[0], device=cuda)
    with pytest.raises(ValueError):  # mixed devices are refused
        dk.closest_kernel(tris, boxes, n_live, o.cpu(), d, tmin, tmin)
    with pytest.raises(ValueError, match="n_live"):
        dk.closest_kernel(tris, boxes, tris.shape[1] + 1, o, d, tmin, tmin)
    before = dk.closest_kernel.launches
    dk.intersect_closest_raw(scene, o, d, 0.0, 100.0)
    assert dk.closest_kernel.launches == before + 1


def _walk_scene_rays(device, max_walk_chunks=None, size=(320, 240),
                     segments=(6, 12)):
    """The `diffuse` README scene cut to (6, 12) sphere segments (34 walk
    chunks of 128, or 256-triangle chunks under a smaller MAX_WALK_CHUNKS;
    segments=None: the full scene, 149 chunks) and its camera's primary
    rays."""
    from optixpathtracer_tpu_torch.scene import flatten as flatten_mod
    model, camera, lights = (scene_material_test("diffuse")
                             if segments is None else
                             scene_material_test("diffuse",
                                                 segments=segments))
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
    return _check_walk_sweeps(scene.walk_tris, wk._chunk_boxes(scene), rays,
                              block_rays)


def _check_walk_sweeps(walk_tris, boxes, rays, block_rays):
    """The candidate kernel and both sweeps against their plain versions on
    one query of (sorted) rays: entries bit-identical, t, ids and blocked
    flags identical; per block, the closest kernel's tests and chunks swept
    exactly the needed-work counts of `wk.needed_work`, the occlusion
    kernel's chunks exactly and its tests within the model's slack (a ray
    blocked in a chunk runs from 1 to all of the chunk's real triangles
    there, as the warps' slices find the blocker). Returns (ids, blocked)."""
    entry = wk.candidates_kernel(boxes, *rays, block_rays)
    assert torch.equal(entry, wk.candidates_plain(boxes, *rays, block_rays))
    cand, tnear, count = wk.sort_candidates(entry)
    kt, ki = wk.closest_kernel(walk_tris, boxes, cand, tnear, count, *rays,
                               block_rays)
    pt, pi = wk.closest_plain(walk_tris, cand, count, *rays, block_rays)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    swept, tests = wk.closest_kernel.swept, wk.closest_kernel.tests
    assert swept.shape == tests.shape == count.shape
    need, chunks = wk.needed_work("closest", walk_tris, boxes, cand, tnear,
                                  count, *rays, block_rays)[:2]
    assert torch.equal(tests.long(), need) and tests.sum() > 0
    assert torch.equal(swept.long(), chunks) and (swept <= count).all()
    kb = wk.any_kernel(walk_tris, boxes, cand, count, *rays, block_rays)
    pb = wk.any_plain(walk_tris, cand, count, *rays, block_rays)
    assert torch.equal(kb, pb)
    assert not kb[rays[3] <= rays[2]].any()  # dead lanes are never blocked
    need, chunks, _, below, above = wk.needed_work(
        "any", walk_tris, boxes, cand, tnear, count, *rays, block_rays)
    tests = wk.any_kernel.tests.long()
    assert torch.equal(wk.any_kernel.swept.long(), chunks)
    assert (tests >= need - below).all() and (tests <= need + above).all()
    assert tests.sum() > 0
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


def test_walk_kernels_scattered_many_candidate_tiles(cuda):
    """The full `diffuse` scene (149 chunks) and a scattered wavefront from
    its primaries' hit points (dead lanes in live warps, tmax = tmin lanes,
    a ragged last block): blocks list more than one 64-candidate tile, and
    the sweeps keep their answers and counts across tiles."""
    scene, o, d = _walk_scene_rays(cuda, segments=None, size=(96, 64))
    o, d = o[:-37].contiguous(), d[:-37].contiguous()
    r = o.shape[0]
    hit = wk.intersect_closest(scene, o, d, 0.0, 100.0)
    t = torch.where(hit.hit, hit.t, torch.full_like(hit.t, wk.BIG))
    rays = _scattered(o, d, t, seed=3)
    perm = wk._coherence_perm(scene, rays[0], rays[1])
    rays = [x[perm].contiguous() for x in rays]
    boxes = wk._chunk_boxes(scene)
    for block_rays in (256, 1024):
        count = wk.sort_candidates(wk.candidates_kernel(boxes, *rays,
                                                        block_rays))[2]
        assert int(count.max()) > 64 and r % block_rays
        ki, kb = _check_walk_sweeps(scene.walk_tris, boxes, rays, block_rays)
        assert (ki >= 0).any() and kb.any() and not kb.all()


@pytest.mark.parametrize("chunk,block_rays", [(128, 256), (256, 256),
                                              (128, 1024), (256, 1024)])
def test_walk_ties_across_chunks(cuda, chunk, block_rays):
    """Two coincident triangles, the higher id in the first candidate chunk
    and the lower id in a chunk 41 candidates later, 40 chunks between them
    that every ray's box test passes and whose triangles lie behind;
    padding slots inside the chunks: both sweeps equal their plain
    versions, and closest returns the lower id whichever warp's slice and
    chunk finds it first."""
    n_chunks = 64
    v0 = np.full((n_chunks * chunk, 3), 1e10, np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)

    def put(c, slot, a, b, c_):
        i = c * chunk + slot
        v0[i], e1[i], e2[i] = a, np.subtract(b, a), np.subtract(c_, a)

    tri = ((-4.0, -4.0, 10.0), (4.0, -4.0, 10.0), (-4.0, 4.0, 10.0))
    late, early = 2, 50            # chunk ids: the lower id comes later
    put(early, chunk - 9, *tri)    # the last warp's slice of its chunk
    put(early, 3, (3.0, 3.0, 1.0), (3.1, 3.0, 1.0), (3.0, 3.1, 1.0))
    put(late, 5, *tri)             # the first warp's slice
    put(late, 6, (3.0, 3.0, 9.5), (3.1, 3.0, 9.5), (3.0, 3.1, 9.5))
    for i in range(40):            # box entry at z 5 .. 9, hit beyond T
        put(8 + i, 0, (4.0, 0.0, 5.0 + 0.1 * i), (-4.0, -4.5, 20.0),
            (-4.0, 4.5, 20.0))
    walk_tris, _, boxes = _walk_layout(v0, e1, e2, chunk, cuda)
    rng = np.random.default_rng(4)
    n = 3 * block_rays - 5
    target = np.concatenate([rng.uniform(-2.0, -0.2, (n, 2)),
                             np.full((n, 1), 10.0)], axis=1)
    o = rng.normal(0.0, 0.01, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 100.0)
    tmax[::7] = 12.0
    tmax[::9] = -1.0
    rays = [torch.tensor(x, dtype=torch.float32, device=cuda).contiguous()
            for x in (o, d, np.zeros(n), tmax)]
    ki, kb = _check_walk_sweeps(walk_tris, boxes, rays, block_rays)
    live = rays[3] > 0
    assert (ki[live] == late * chunk + 5).all() and kb[live].all()
    cand = wk.sort_candidates(wk.candidates_kernel(boxes, *rays,
                                                   block_rays))[0]
    rank = (cand == late).int().argmax(dim=1)
    assert ((cand[:, 0] == early) & (rank == 41)).all()


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


def _word_exit_tests(kind, walk_tris, cand, tnear, words, rays, block_rays,
                     per_subchunk=False):
    """Ray-triangle tests per ray block of a packet sweep that exits only
    at word ends, as the first CUDA port of the packet kernels did: closest
    stops after word w once tnear of word w + 1's first rank exceeds the max
    over live rays of min(best t, tmax); any sweeps until every live ray is
    blocked, lane b testing triangles b + 32 m in order of m until a hit.
    With per_subchunk (closest only), the sweep the kernel runs: it stops
    before the first set subchunk whose rank's tnear exceeds that limit
    over the subchunks swept before it. Built from the plain sweep's
    per-(packet, subchunk) hits; a swept subchunk costs 128 tests a live
    ray of the closest sweep."""
    n_sub = walk_tris.shape[2] // pk.SUB
    nb, packets, n_words = words.shape
    bits = ((words[..., None] >> torch.arange(32, device=words.device)) & 1
            ).view(nb * packets, -1)
    packet, s = torch.nonzero(bits, as_tuple=True)
    tmin, tmax = (pk._packets(x, block_rays).reshape(-1, pk.PACKET)
                  for x in wk._blocked(*rays, block_rays)[2:])
    live = tmax > tmin                                     # [P, 8]
    n_live = live.sum(dim=1)
    tests = torch.zeros(nb * packets, dtype=torch.long, device=words.device)
    if packet.numel() == 0:
        return tests.view(nb, packets).sum(dim=1)
    hits = list(pk._pair_steps(walk_tris, words, cand, *rays, block_rays))
    hit = torch.cat([h for _, _, _, h in hits])            # [pairs, 8, 128]
    # a packet's pairs are consecutive, in sweep order
    pair = torch.arange(packet.numel(), device=s.device)
    seg = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                     packet[1:] != packet[:-1]])
    start = torch.cummax(torch.where(seg, pair, 0), dim=0).values
    blk = torch.arange(nb * packets, device=words.device) // packets
    if kind == "closest" and per_subchunk:
        t = torch.cat([torch.where(h, t, pk.BIG).amin(dim=2)
                       for _, _, t, h in hits])           # [pairs, 8]
        pos = pair - start
        dense = torch.full((nb * packets, int(pos.max()) + 1, pk.PACKET),
                           pk.BIG, device=words.device)
        dense[packet, pos] = t
        before = torch.cat([torch.full_like(dense[:, :1], pk.BIG),
                            dense.cummin(dim=1).values[:, :-1]], dim=1)
        limit = torch.where(live[packet],
                            torch.minimum(before[packet, pos], tmax[packet]),
                            -float("inf")).amax(dim=1)    # [pairs]
        stop = (tnear[blk[packet], s // n_sub] > limit).long()
        cum = stop.cumsum(dim=0)
        swept = cum - (cum - stop)[start] == 0
        per_pair = n_live[packet] * pk.SUB
    elif kind == "closest":
        t = torch.cat([torch.where(h, t, pk.BIG).amin(dim=2)
                       for _, _, t, h in hits])           # [pairs, 8]
        best = torch.full((nb * packets, n_words, pk.PACKET), pk.BIG,
                          device=words.device)
        idx = (packet * n_words + s // 32)[:, None].expand(-1, pk.PACKET)
        best.view(-1, pk.PACKET).scatter_reduce_(0, idx, t, "amin")
        best = best.cummin(dim=1).values
        limit = torch.where(live[:, None], torch.minimum(best, tmax[:, None]),
                            -float("inf")).amax(dim=2)    # [P, W]
        j_next = ((torch.arange(n_words, device=words.device) + 1) * 32
                  // n_sub).clamp(max=cand.shape[1] - 1)
        stop = tnear[blk][:, j_next] > limit
        stop[:, -1] = True
        last = stop.int().argmax(dim=1)                    # exit word
        swept = s // 32 <= last[packet]
        per_pair = n_live[packet] * pk.SUB
    else:
        h = hit.view(-1, pk.PACKET, pk.SUB // 32, 32)      # [pairs, 8, m, b]
        before = h.int().cumsum(dim=2) - h.int()           # hits at m' < m
        ray_tests = (before == 0).sum(dim=(2, 3))          # [pairs, 8]
        ray_hit = h.any(dim=3).any(dim=2)                  # [pairs, 8]
        cum = ray_hit.long().cumsum(dim=0)
        base = (cum - ray_hit.long())[start]
        blocked_after = (cum - base) > 0                   # [pairs, 8]
        blocked_before = (cum - ray_hit.long() - base) > 0
        open_ = live[packet] & ~blocked_before
        all_blocked = (blocked_after | ~live[packet]).all(dim=1)
        ended = all_blocked.long().cumsum(dim=0)
        ended_before = ended - all_blocked.long() - (
            ended - all_blocked.long())[start]
        swept = (ended_before == 0) & open_.any(dim=1)
        per_pair = (ray_tests * open_).sum(dim=1)
    tests.index_add_(0, packet[swept], per_pair[swept].long())
    tests[n_live == 0] = 0
    return tests.view(nb, packets).sum(dim=1)


def _sorted_rays(scene, o, d, tmin, tmax):
    perm = wk._coherence_perm(scene, o, d)
    return [x[perm].contiguous() for x in (o, d, tmin, tmax)]


def _check_packet_kernels(walk_tris, sub_box, boxes, rays, block_rays):
    """Both packet kernels against the plain words and sweeps on one query
    of (sorted) rays: words bit-identical, ids, t and blocked flags
    identical; the closest kernel's tests per block exactly those of its
    per-subchunk exit, and no block running more tests than a sweep that
    exits only at word ends; the occlusion kernel's at least one a swept
    subchunk and one a blocked ray. Returns (ids, blocked, closest tests,
    word-exit closest tests)."""
    chunk = walk_tris.shape[2]
    cand, tnear, count = wk.sort_candidates(
        wk.candidates_kernel(boxes, *rays, block_rays))
    args = (walk_tris, sub_box, cand, tnear, count, *rays, block_rays)
    words = pk.packet_words_plain(sub_box, cand, tnear, *rays, chunk,
                                  block_rays)[0]
    kt, ki = pk.packet_closest_kernel(*args, with_words=True)
    pt, pi = pk.packet_closest_plain(walk_tris, cand, words, *rays,
                                     block_rays)
    torch.cuda.synchronize()
    assert torch.equal(pk.packet_closest_kernel.words, words)
    assert torch.equal(ki, pi)
    assert torch.equal(kt, pt)
    k = pk.packet_closest_kernel
    assert k.swept.shape == k.tests.shape == k.slabs.shape == count.shape
    assert (k.tests <= k.swept * 8 * pk.SUB).all() and k.tests.sum() > 0
    assert (k.tests >= k.swept * pk.SUB).all()  # a live ray a packet swept
    closest_tests = k.tests.long()
    assert torch.equal(closest_tests, _word_exit_tests(
        "closest", walk_tris, cand, tnear, words, rays, block_rays,
        per_subchunk=True))
    word_exit = _word_exit_tests("closest", walk_tris, cand, tnear, words,
                                 rays, block_rays)
    assert (closest_tests <= word_exit).all()
    # the same answers without the words: the exit then skips them
    kt2, ki2 = pk.packet_closest_kernel(*args)
    assert torch.equal(ki2, pi) and torch.equal(kt2, pt)
    assert torch.equal(k.tests.long(), closest_tests)
    kb = pk.packet_any_kernel(*args, with_words=True)
    pb = pk.packet_any_plain(walk_tris, cand, words, *rays, block_rays)
    assert torch.equal(pk.packet_any_kernel.words, words)
    assert torch.equal(kb, pb)
    assert not kb[rays[3] <= rays[2]].any()  # dead rays are never blocked
    ka = pk.packet_any_kernel
    assert (ka.tests.long() <= _word_exit_tests(
        "any", walk_tris, cand, tnear, words, rays, block_rays)).all()
    n_blocked = torch.zeros(count.shape[0] * block_rays, dtype=torch.int32,
                            device=kb.device)
    n_blocked[:kb.shape[0]] = kb
    assert (ka.tests >= torch.maximum(
        ka.swept, n_blocked.view(-1, block_rays).sum(dim=1))).all()
    assert ka.tests.sum() > 0
    assert torch.equal(pk.packet_any_kernel(*args), pb)
    return ki, kb, closest_tests, word_exit


def _dead_packets(rays, block_rays):
    """Cut 13 rays off the end (the last block is part padding) and kill
    whole packets of the sorted rays: packets 1-2 with tmax = -1, packet 3
    with tmax = tmin = 0.5 (slab tests may pass, no ray can hit)."""
    o, d, tmin, tmax = (x[:-13].clone() for x in rays)
    tmax[8:24] = -1.0
    tmin[24:32] = 0.5
    tmax[24:32] = 0.5
    return [o, d, tmin, tmax]


@pytest.mark.parametrize("block_rays,max_walk_chunks,one_word_tiles", [
    (256, None, False), (1024, None, False), (256, 20, False),
    (256, None, True), (1024, None, True)])
def test_packet_kernels_match_plain(cuda, monkeypatch, block_rays,
                                    max_walk_chunks, one_word_tiles):
    """At chunk 128 and (MAX_WALK_CHUNKS = 20) at chunk 256, on primaries
    (where the closest sweep exits mid-word) and on scattered rays from the
    hit points, with dead lanes, dead packets and rays past the end. With
    one_word_tiles, on the full `diffuse` scene (149 chunks), the
    shared-memory budget leaves room for one word of the union a tile, so
    a block with more than 32 candidates sweeps several tiles."""
    scene, o, d = _walk_scene_rays(cuda, max_walk_chunks,
                                   segments=None if one_word_tiles
                                   else (6, 12))
    chunk = scene.walk_chunk
    assert chunk == (128 if max_walk_chunks is None else 256)
    maxc_pad = -(-scene.walk_tris.shape[0] // wk.LANES) * wk.LANES
    if one_word_tiles:
        step = 32 * pk.SUB // chunk
        monkeypatch.setattr(pk, "SMEM_BUDGET",
                            pk.smem_bytes(step, chunk, block_rays))
        assert pk.smem_plan(chunk, block_rays, maxc_pad)[0] == step
    tile = pk.smem_plan(chunk, block_rays, maxc_pad)[0]
    r = o.shape[0]
    tmin = torch.zeros(r, device=cuda)
    tmax = torch.full((r,), 100.0, device=cuda)
    tmax[::11] = -1.0
    boxes = wk._chunk_boxes(scene)
    rays = _sorted_rays(scene, o, d, tmin, tmax)
    args = (scene.walk_tris, scene.walk_sub_box, boxes)
    ki, kb, tests, word_exit = _check_packet_kernels(*args, rays, block_rays)
    assert (ki >= 0).any() and (ki < 0).any() and kb.any()
    assert tests.sum() < word_exit.sum()  # exits inside words
    _check_packet_kernels(*args, _dead_packets(rays, block_rays), block_rays)
    hit = wk.intersect_closest(scene, o, d, 0.0, 100.0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    dirs = torch.randn((r, 3), generator=gen).to(cuda)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    origins = (o + hit.t[:, None] * d + 1e-3 * dirs).contiguous()
    tmax = torch.where(hit.hit, 5.0, -1.0)
    rays = _sorted_rays(scene, origins, dirs.contiguous(), tmin, tmax)
    _check_packet_kernels(*args, rays, block_rays)
    count = wk.sort_candidates(wk.candidates_kernel(boxes, *rays,
                                                    block_rays))[2]
    if one_word_tiles:
        assert int(count.max()) > tile  # two tiles or more
    from optixpathtracer_tpu_torch.intersect import brute
    got = pk.intersect_closest(scene, origins, dirs, 0.0, tmax, block_rays)
    want = brute.intersect_closest(scene, origins, dirs, 0.0, tmax)
    assert torch.equal(got.tri_id, want.tri_id)


def _walk_layout(v0, e1, e2, chunk, device):
    """walk_tris [C, 16, chunk], subchunk boxes [6, C * n_sub] and chunk
    boxes [6, C] of triangles laid out in the given order (v0 = 1e10 rows
    are padding: no box, as flatten pads)."""
    n = v0.shape[0]
    assert n % chunk == 0
    walk = np.zeros((n // chunk, 16, chunk), np.float32)
    tris = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)
    walk[:, :9] = tris.reshape(n // chunk, chunk, 9).transpose(0, 2, 1)
    valid = v0[:, 0] < 1e9
    big = np.float32(3.4e38)
    vs = np.stack([v0, v0 + e1, v0 + e2]).astype(np.float32)
    lo = np.where(valid[:, None], vs.min(axis=0), big)
    hi = np.where(valid[:, None], vs.max(axis=0), -big)

    def boxes(size):
        b_lo = lo.reshape(-1, size, 3).min(axis=1)
        b_hi = hi.reshape(-1, size, 3).max(axis=1)
        empty = b_lo[:, :1] > b_hi[:, :1]
        return np.concatenate([np.where(empty, big, b_lo).T,
                               np.where(empty, big, b_hi).T])

    return tuple(torch.tensor(np.ascontiguousarray(x), device=device)
                 for x in (walk, boxes(pk.SUB), boxes(chunk)))


@pytest.mark.parametrize("chunk,block_rays", [(128, 256), (256, 256),
                                              (128, 1024), (256, 1024)])
def test_packet_ties_across_words(cuda, chunk, block_rays):
    """Two coincident triangles, the higher id in the first candidate and
    the lower id 41 ranks later (another word), 40 chunks between them
    that every ray's box test passes and whose triangles lie behind: both
    kernels return the lower id, as the plain versions do."""
    n_chunks = 64
    v0 = np.full((n_chunks * chunk, 3), 1e10, np.float32)
    e1 = np.zeros_like(v0)
    e2 = np.zeros_like(v0)

    def put(c, slot, a, b, c_):
        i = c * chunk + slot
        v0[i], e1[i], e2[i] = a, np.subtract(b, a), np.subtract(c_, a)

    tri = ((-4.0, -4.0, 10.0), (4.0, -4.0, 10.0), (-4.0, 4.0, 10.0))
    late, early = 2, 50            # chunk ids: the lower id comes later
    put(early, chunk - 9, *tri)    # last subchunk of its chunk
    put(early, 3, (3.0, 3.0, 1.0), (3.1, 3.0, 1.0), (3.0, 3.1, 1.0))
    put(late, 5, *tri)
    put(late, 6, (3.0, 3.0, 9.5), (3.1, 3.0, 9.5), (3.0, 3.1, 9.5))
    for i in range(40):            # box entry at z 5 .. 9, hit beyond T
        put(8 + i, 0, (4.0, 0.0, 5.0 + 0.1 * i), (-4.0, -4.5, 20.0),
            (-4.0, 4.5, 20.0))
    walk_tris, sub_box, boxes = _walk_layout(v0, e1, e2, chunk, cuda)
    rng = np.random.default_rng(3)
    n = 3 * block_rays - 5
    target = np.concatenate([rng.uniform(-2.0, -0.2, (n, 2)),
                             np.full((n, 1), 10.0)], axis=1)
    o = rng.normal(0.0, 0.01, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 100.0)
    tmax[::7] = 12.0
    rays = [torch.tensor(x, dtype=torch.float32, device=cuda).contiguous()
            for x in (o, d, np.zeros(n), tmax)]
    ki, kb, _, _ = _check_packet_kernels(walk_tris, sub_box, boxes, rays,
                                         block_rays)
    assert (ki == late * chunk + 5).all()
    assert kb.all()
    cand = wk.sort_candidates(wk.candidates_kernel(boxes, *rays,
                                                   block_rays))[0]
    rank = (cand == late).int().argmax(dim=1)
    assert ((cand[:, 0] == early) & (rank == 41)).all()


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


def test_cli_kernels_match_plain(cuda, tmp_path):
    """The CLI on Cornell at 64x64 (the default device, the GPU) through
    the dense kernels, with a checkpoint and all three outputs, equals the
    plain versions' render by the engine-golden criterion; its EXR holds
    the returned accumulator bit for bit."""
    from optixpathtracer_tpu_torch import cli
    from optixpathtracer_tpu_torch.film import read_exr
    from optixpathtracer_tpu_torch.render import load_checkpoint

    def run(tag):
        out = [str(tmp_path / f"{tag}.{e}") for e in ("exr", "png", "bmp",
                                                     "npz")]
        assert cli.main(["--scene", "scene3_cornell", "--width", "64",
                         "--height", "64", "--spp", "2", "--max-bounces",
                         "2", "--out-exr", out[0], "--out-png", out[1],
                         "--out-bmp", out[2], "--checkpoint", out[3]]) == 0
        accum, n = load_checkpoint(out[3])
        img = read_exr(out[0])
        assert n == 2 and accum.is_cuda
        np.testing.assert_array_equal(img, accum.cpu().numpy())
        return img

    before = dk.closest_kernel.launches, dk.any_kernel.launches
    img = run("kernels")
    assert dk.closest_kernel.launches - before[0] == 4
    assert dk.any_kernel.launches - before[1] == 4
    with plain_kernels():
        want = run("plain")
    assert np.isfinite(img).all() and img.mean() > 0.005
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


# ---------------------------------------------------------------------------
# The trace_paths options and the backward pass, through the kernels
# ---------------------------------------------------------------------------

def test_layered_gradients_kernels_equal_plain(cuda):
    """Material-table gradients of the layered scene (34 walk chunks) at
    32x32 through the walk kernels equal the plain versions' bit for bit:
    the kernels only choose the triangle."""
    model, camera, lights = scene_material_test("layered", segments=(6, 12))
    scene = flatten_model(model, lights, device=cuda)
    cam = camera.raygen_params(32, 32, cuda)
    kw = dict(fields=("mat_albedo", "mat_metallic", "mat_roughness",
                      "mat_ior"), max_bounces=2, intersect_method="auto")
    before = wk.closest_kernel.launches
    got = param_gradients(scene, cam, 32, 32, [0, 1], **kw)
    assert wk.closest_kernel.launches > before
    with plain_kernels():
        want = param_gradients(scene, cam, 32, 32, [0, 1], **kw)
    for field, g in got.items():
        assert torch.isfinite(g).all() and torch.equal(g, want[field]), field
    assert got["mat_albedo"].abs().max() > 0


@pytest.fixture(scope="module")
def diffuse_scene(cuda):
    model, camera, lights = PRESETS["diffuse"]()
    return flatten_model(model, lights, device=cuda), camera


@pytest.mark.parametrize("kw", [{"sort_rays": True}, {"sort_rays": "morton"}])
def test_sorted_frames_equal_unsorted(diffuse_scene, kw):
    """`diffuse` (149 walk chunks) at 64x64, 3 bounces: sorting the
    wavefront changes no lane's arithmetic and no hit, so the frame is the
    unsorted one bit for bit."""
    scene, camera = diffuse_scene
    params = camera.raygen_params(64, 64, scene.device)
    flags = dict(active_lobes=(dispatch.DIFFUSE,), use_textures=False)
    before = wk.closest_kernel.launches
    img = path.render_sample(scene, *params, 64, 64, 0, 3, **flags, **kw)
    assert wk.closest_kernel.launches > before
    want = path.render_sample(scene, *params, 64, 64, 0, 3, **flags)
    assert img.mean() > 0.005 and torch.equal(img, want)


# ---------------------------------------------------------------------------
# The layered glossy-diffuse lobe's kernels
# ---------------------------------------------------------------------------

LOBE_LANES = 1 << 20


def _layered_inputs(device, seed):
    """LOBE_LANES lanes of lobe inputs drawn with numpy: uniform directions
    (wo.z < 0 and opposite-hemisphere wi on about half the lanes each);
    roughness 0 (the smooth path) on 1/8 of the lanes, about 0.0316 (alpha
    at the 1e-3 smooth edge, both sides) on 1/8, else in (0, 1]; eta in
    [1, 2] with 1.0 on 1/8; albedo with one zero channel on 1/8 and all
    zero on 1/16, and in [0.02, 0.2] on 1/4, where a walk's throughput
    falls below 0.25 and Russian roulette fires."""
    r = np.random.default_rng(seed)

    def unit():
        v = r.normal(size=(LOBE_LANES, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    rough = r.uniform(1e-3, 1.0, LOBE_LANES).astype(np.float32)
    rough[0::8] = 0.0
    rough[1::8] = r.uniform(0.0312, 0.0320, rough[1::8].shape)
    eta = r.uniform(1.0, 2.0, LOBE_LANES).astype(np.float32)
    eta[2::8] = 1.0
    albedo = r.uniform(0.0, 1.0, (LOBE_LANES, 3)).astype(np.float32)
    albedo[3::8, r.integers(0, 3)] = 0.0
    albedo[4::16] = 0.0
    albedo[5::4] = r.uniform(0.02, 0.2, albedo[5::4].shape)
    seeds = r.integers(0, 2**32, LOBE_LANES, dtype=np.uint64).astype(
        np.int64)
    t = functools.partial(torch.as_tensor, device=device)
    return dict(seed=t(seeds), albedo=t(albedo), roughness=t(rough),
                wo=t(unit()), wi=t(unit()), eta=t(eta))


def _assert_bits_equal(got, want, what):
    """Equal bit for bit (NaN and the sign of zero included)."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    bad = got != want
    if bad.dim() > 1:
        bad = bad.flatten(1).any(dim=1)
    assert not bad.any(), (f"{what}: {int(bad.sum())} lanes differ, first "
                           f"{torch.nonzero(bad)[:4].flatten().tolist()}")


@pytest.mark.parametrize("kw", [
    {},
    {"n_samples": 11, "max_depth": 7},
    {"n_samples": 2, "max_depth": 12, "thickness": 0.0},
])
def test_layered_lobe_kernels_equal_plain(cuda, kw):
    """The dispatch's launchers of the layered lobe's kernels, on 2^20
    lanes all of that type, equal the plain lobe bit for bit: the f
    kernel's rgb (the plain lobe's seed unchanged); the sample kernel's
    seed, color, direction, pdf and every flag. The defaults, more walks
    than a block's 8 warps with a shorter walk, and a thin layer with a
    longer one."""
    x = _layered_inputs(cuda, 15 + len(kw))
    f_args = (x["seed"], x["albedo"], x["roughness"], x["wo"], x["wi"],
              x["eta"])
    f_kw = {"n_samples": gd.N_SAMPLES, "max_depth": gd.MAX_DEPTH,
            "thickness": gd.THICKNESS, **kw}
    s_kw = {k: v for k, v in f_kw.items() if k != "n_samples"}
    layered = torch.full(x["eta"].shape, dispatch.GLOSSY_DIFFUSE,
                         dtype=torch.int32, device=cuda)
    draws = [0, 0, 0, gd.sample_draws(s_kw["max_depth"])]
    launches = bk.layered_f.launches, bk.lobes_sample.launches
    with torch.no_grad():
        f_k = bk.layered_f(x["seed"], layered, *f_args[1:], **f_kw)
        seed_p, f_p = gd.f(*f_args, **f_kw)
        sk = bk.lobes_sample(x["seed"], layered, *f_args[1:4], x["eta"],
                             dispatch.lobe_mask((dispatch.GLOSSY_DIFFUSE,)),
                             draws, **s_kw)
        sp = gd.sample(*f_args[:4], x["eta"], **s_kw)
    torch.cuda.synchronize()
    assert (bk.layered_f.launches, bk.lobes_sample.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.equal(seed_p, x["seed"])
    _assert_bits_equal(f_k, f_p, "f rgb")
    assert (f_k > 0).any(dim=1).float().mean() > 0.2
    _assert_bits_equal(sk[0], sp[0], "sample seed")
    for field in sk[1]._fields:
        _assert_bits_equal(getattr(sk[1], field), getattr(sp[1], field),
                           f"sample {field}")
    valid = sk[1].valid
    assert 0.2 < float(valid.float().mean()) < 1.0
    assert sk[1].specular[valid].any() and sk[1].glossy[valid].any()
    assert sk[1].reflection[valid].all()  # the Lambert base never transmits


def test_layered_lobe_kernel_launch_errors_raise(cuda):
    x = _layered_inputs(cuda, 3)
    layered = torch.full(x["eta"].shape, dispatch.GLOSSY_DIFFUSE,
                         dtype=torch.int32, device=cuda)
    mask = dispatch.lobe_mask((dispatch.GLOSSY_DIFFUSE,))
    draws = [0, 0, 0, gd.sample_draws()]
    with pytest.raises(ValueError):
        bk.layered_f(x["seed"].int(), layered, x["albedo"], x["roughness"],
                     x["wo"], x["wi"], x["eta"])
    with pytest.raises(ValueError):
        bk.lobes_sample(x["seed"], layered, x["albedo"].cpu(),
                        x["roughness"], x["wo"], x["eta"], mask, draws)
    with pytest.raises(ValueError):
        bk.layered_f(x["seed"], layered, x["albedo"], x["roughness"],
                     x["wo"], x["wi"], x["eta"], n_samples=0)
    with pytest.raises(ValueError):
        bk.layered_f(x["seed"], layered.long(), x["albedo"], x["roughness"],
                     x["wo"], x["wi"], x["eta"])


def _lobe_launches():
    """Launches of the layered f, closed-form f and sample kernels."""
    return (bk.layered_f.launches, bk.lobes_f.launches,
            bk.lobes_sample.launches)


def _launched(before):
    return tuple(a - b for a, b in zip(_lobe_launches(), before))


def test_layered_frame_lobe_kernels_equal_plain(cuda):
    """A 256x256 `layered` frame (2 bounces) through render_chunk with the
    kernels equals the plain versions' bit for bit; the layered f and the
    sample kernel launch once a bounce there, the closed-form f kernel not
    at all (the scene has the layered lobe alone), and none under
    param_gradients, where autograd records the lobe."""
    from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes
    model, camera, lights = PRESETS["layered"]()
    scene = flatten_model(model, lights, device=cuda)
    params = camera.raygen_params(256, 256, cuda)
    kw = dict(active_lobes=scene_active_lobes(scene), use_textures=False)
    accum = torch.zeros(256, 256, 3, device=cuda)
    before = _lobe_launches()
    img = path.render_chunk(scene, *params, 256, 256, accum, 0, 1, 2, **kw)
    assert _launched(before) == (2, 0, 2)
    with plain_kernels():
        want = path.render_chunk(scene, *params, 256, 256, accum, 0, 1, 2,
                                 **kw)
    assert img.mean() > 0.005 and torch.equal(img, want)

    before = _lobe_launches()
    grads = param_gradients(scene, camera.raygen_params(32, 32, cuda), 32,
                            32, [0], fields=("mat_albedo", "mat_roughness"),
                            max_bounces=2)
    assert grads["mat_albedo"].abs().max() > 0
    assert _launched(before) == (0, 0, 0)


# ---------------------------------------------------------------------------
# The BSDF dispatch's kernels: each lane evaluates its own lobe
# ---------------------------------------------------------------------------

def _dispatch_inputs(device, seed):
    """`_layered_inputs` with a material type a lane, of all four lobes and
    metallic-mix (metallic in [0, 1]), resolved as the surface resolves it,
    and two kinds of degenerate lanes, such as dead lanes carry: wo.z = 0
    on 1/64 of the lanes, wo = wi = 0 on 1/64. The dielectric lanes with
    wo.z < 0 and eta > 1 include total internal reflection."""
    x = _layered_inputs(device, seed)
    r = np.random.default_rng(seed)
    t = functools.partial(torch.as_tensor, device=device)
    wo, wi = x["wo"].clone(), x["wi"].clone()
    wo[10::64, 2] = 0.0
    wo[11::64] = 0.0
    wi[11::64] = 0.0
    mat = dispatch.MaterialParams(
        albedo=x["albedo"],
        metallic=t(r.uniform(0.0, 1.0, LOBE_LANES).astype(np.float32)),
        roughness=x["roughness"], ior=x["eta"],
        mat_type=t(r.integers(0, 5, LOBE_LANES).astype(np.int32)))
    seed, mat = dispatch.resolve_stochastic_lobe(x["seed"], mat)
    return seed, mat, wo, wi


def _assert_outputs_equal(got, want, what):
    """A dispatch call's (seed, rgb) or (seed, BSDFSample), bit for bit."""
    (seed_k, rest_k), (seed_p, rest_p) = got, want
    _assert_bits_equal(seed_k, seed_p, f"{what} seed")
    if isinstance(rest_p, torch.Tensor):
        _assert_bits_equal(rest_k, rest_p, f"{what} rgb")
        return
    for field in rest_p._fields:
        _assert_bits_equal(getattr(rest_k, field), getattr(rest_p, field),
                           f"{what} {field}")


@pytest.mark.parametrize("lobes", [
    (dispatch.DIFFUSE,),
    (dispatch.GLOSSY_DIFFUSE,),
    dispatch.ALL_LOBES,
    (dispatch.DIFFUSE, dispatch.DIELECTRIC, dispatch.GLOSSY_DIFFUSE),
    (dispatch.DIFFUSE, dispatch.CONDUCTOR, dispatch.DIELECTRIC),
])
def test_dispatch_kernels_equal_plain(cuda, lobes):
    """dispatch.f and sample through the kernels equal the plain dispatch
    bit for bit on 2^20 lanes of every resolved type (`_dispatch_inputs`):
    rgb and the unchanged seed; seed, color, direction, pdf and every
    flag. Active lobes (0,), (3,), all four, and all four but one. Only
    the kernels of the lobes asked for launch: the layered f kernel for
    the layered lobe, the closed-form one for the others (or where no lobe
    is asked for), one sample kernel."""
    seed, mat, wo, wi = _dispatch_inputs(cuda, 40 + len(lobes))
    on = list(lobes)
    layered = dispatch.GLOSSY_DIFFUSE in on
    closed = any(lobe != dispatch.GLOSSY_DIFFUSE for lobe in on)
    before = _lobe_launches()
    with torch.no_grad():
        got_f = dispatch.f(seed, mat, wo, wi, lobes)
        got_s = dispatch.sample(seed, mat, wo, lobes)
        assert _launched(before) == (layered, closed or not layered, 1)
        with plain_bsdf():
            want_f = dispatch.f(seed, mat, wo, wi, lobes)
            want_s = dispatch.sample(seed, mat, wo, lobes)
    torch.cuda.synchronize()
    assert got_f[0] is seed and want_f[0] is seed
    _assert_outputs_equal(got_f, want_f, "f")
    _assert_outputs_equal(got_s, want_s, "sample")
    t, rgb, s = mat.mat_type, got_f[1], got_s[1]
    for lobe in on:  # each lobe asked for gives its own lanes values
        own = t == lobe
        assert (rgb[own] > 0).any() and s.valid[own].any(), lobe
    off = ~torch.isin(t, torch.tensor(on, dtype=t.dtype, device=t.device))
    assert not rgb[off].any() and not s.valid[off].any()


def test_hall_frame_dispatch_kernels_equal_plain(cuda):
    """One 1920x1080 hall frame (2 bounces: every lobe, textures, alpha
    cutout) through render_chunk. At each bounce's wavefront the
    dispatch's kernels equal the plain dispatch bit for bit on every lane,
    dead ones included, and the frame equals the one whose dispatch runs
    the plain versions (the intersection kernels in both) bit for bit.
    Each of the three kernels launches once a bounce."""
    from optixpathtracer_tpu_torch.integrate.cutout import \
        scene_uses_alpha_cutout
    from optixpathtracer_tpu_torch.scene.flatten import (
        scene_active_lobes, scene_flat_shading, scene_uses_textures)
    model, camera, lights = PRESETS["hall"]()
    scene = flatten_model(model, lights, device=cuda)
    w, h = 1920, 1080
    params = camera.raygen_params(w, h, cuda)
    kw = dict(active_lobes=scene_active_lobes(scene),
              use_textures=scene_uses_textures(scene),
              use_alpha_cutout=scene_uses_alpha_cutout(scene),
              flat_shading=scene_flat_shading(scene))
    assert kw["active_lobes"] == dispatch.ALL_LOBES
    calls, saved = [], (dispatch.f_kernel, dispatch.sample_kernel)

    def recorded(kind, fn):
        def run(*args):
            out = fn(*args)
            calls.append((kind, args, out))
            return out
        return run

    accum = torch.zeros(h, w, 3, device=cuda)
    before = _lobe_launches()
    dispatch.f_kernel = recorded("f", saved[0])
    dispatch.sample_kernel = recorded("sample", saved[1])
    try:
        img = path.render_chunk(scene, *params, w, h, accum, 0, 1, 2, **kw)
    finally:
        dispatch.f_kernel, dispatch.sample_kernel = saved
    assert _launched(before) == (2, 2, 2)
    assert [c[0] for c in calls] == ["f", "sample"] * 2
    plains = {"f": dispatch.f_plain, "sample": dispatch.sample_plain}
    with torch.no_grad(), plain_bsdf():
        for i, (kind, args, out) in enumerate(calls):
            _assert_outputs_equal(out, plains[kind](*args),
                                  f"bounce {i // 2} {kind}")
        want = path.render_chunk(scene, *params, w, h, accum, 0, 1, 2, **kw)
    assert img.mean() > 0.005 and torch.equal(img, want)


# ---------------------------------------------------------------------------
# The alpha-cutout chain kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hall(cuda):
    """The 1080p hall (338,270 triangles; cutout sub-scene of 40) and the
    raygen parameters and shading options of its frames."""
    from optixpathtracer_tpu_torch.scene.flatten import (
        scene_active_lobes, scene_flat_shading, scene_uses_textures)
    model, camera, lights = PRESETS["hall"]()
    scene = flatten_model(model, lights, device=cuda)
    kw = dict(active_lobes=scene_active_lobes(scene),
              use_textures=scene_uses_textures(scene),
              use_alpha_cutout=cutout.scene_uses_alpha_cutout(scene),
              flat_shading=scene_flat_shading(scene))
    return scene, camera.raygen_params(1920, 1080, cuda), kw


def _chain_launches():
    return (cutout.closest_chain_kernel.launches
            + cutout.any_chain_kernel.launches)


@contextlib.contextmanager
def recorded_chains():
    """Record (kind, args, outputs, reentries) of every chain kernel call.
    A wrapper counts on the module's name for it, so the recorder carries
    the counters while it stands in and hands them back."""
    calls, saved = [], (cutout.closest_chain_kernel, cutout.any_chain_kernel)

    def recorded(kind, fn):
        def run(*args):
            out = fn(*args)
            calls.append((kind, args, out, int(run.last_reentries)))
            return out
        run.launches, run.last_reentries = fn.launches, fn.last_reentries
        return run

    stand_ins = (recorded("closest", saved[0]), recorded("any", saved[1]))
    cutout.closest_chain_kernel, cutout.any_chain_kernel = stand_ins
    try:
        yield calls
    finally:
        for fn, run in zip(saved, stand_ins):
            fn.launches, fn.last_reentries = run.launches, run.last_reentries
        cutout.closest_chain_kernel, cutout.any_chain_kernel = saved


def _assert_chain_equal(kind, args, out, reentries, what):
    """One chain kernel call against the plain chain on the same inputs
    (its dense sweeps the dense kernels): bit for bit, and its re-traced
    layers equal to the plain count."""
    sub, o, d, tmin, tmax = args[:5]
    if kind == "closest":
        want = cutout.closest_chain_plain(sub, o, d, tmin, tmax)
        assert torch.equal(out[1], want[1]), what
        assert torch.equal(out[0], want[0]), what
    else:
        want = cutout.any_chain_plain(sub, o, d, tmin, tmax, args[5])
        assert torch.equal(out, want), what
    assert reentries == cutout.chain_reentries(kind, *args), what


def test_cutout_chain_kernels_equal_plain_on_hall_wavefronts(hall):
    """Every chain of a 1080p hall frame (2 bounces: the radiance and the
    shadow chain a bounce, dead and gated-out lanes included) through the
    kernels equals the plain chain bit for bit, re-entries included; the
    kernels launch 4 times a frame and the plain chain never runs."""
    scene, params, kw = hall
    assert cutout._uses_chain_kernel(scene.cutout_sub, params[0], "auto")
    accum = torch.zeros(1080, 1920, 3, device=params[0].device)
    before = (_chain_launches(), dk.closest_kernel.launches)
    with recorded_chains() as calls:
        path.render_chunk(scene, *params, 1920, 1080, accum, 0, 1, 2, **kw)
    assert _chain_launches() - before[0] == 4
    assert dk.closest_kernel.launches == before[1]
    assert [c[0] for c in calls] == ["closest", "any"] * 2
    dead = sum(int((c[1][4] <= c[1][3]).sum()) for c in calls)
    assert dead > 0 and sum(c[3] for c in calls) > 0
    for i, (kind, args, out, reentries) in enumerate(calls):
        _assert_chain_equal(kind, args, out, reentries,
                            f"bounce {i // 2} {kind}")


def test_cutout_chain_kernels_exhaust_on_stacked_quads(cuda):
    """Six aligned holes (lanes exhaust MAX_CUTOUT_LAYERS, lanes starting
    past the first quads, a dead lane) and a coincident hole / leaf pair (a
    t tie): the kernels equal the plain chain bit for bit, the hand
    expectations hold, and each launch counts the hand count of re-traced
    layers."""
    model, lights = stack_model()
    scene = flatten_model(model, lights, device=cuda)
    sub = scene.cutout_sub
    lanes = [lane for lane, *_ in LANES.values()] + [TIE_LANE]
    o, d, tmin, tmax = stack_rays(lanes * 300, cuda)  # several blocks
    gate = torch.ones_like(tmin, dtype=torch.bool)
    gate[::5] = False
    assert cutout._uses_chain_kernel(sub, o, "auto")
    closest = cutout.closest_chain_kernel(sub, o, d, tmin, tmax)
    _assert_chain_equal("closest", (sub, o, d, tmin, tmax), closest,
                        int(cutout.closest_chain_kernel.last_reentries),
                        "closest")
    blocked = cutout.any_chain_kernel(sub, o, d, tmin, tmax, gate)
    _assert_chain_equal("any", (sub, o, d, tmin, tmax, gate), blocked,
                        int(cutout.any_chain_kernel.last_reentries), "any")
    for j, (name, (_, t, b, _)) in enumerate(LANES.items()):
        got = float(closest[0][j])
        assert got == (float("inf") if t is None else
                       pytest.approx(t, abs=1e-5)), name
        open_copy = next(i for i in range(j, len(gate), len(lanes))
                         if gate[i])
        assert bool(blocked[open_copy]) == b, name
    assert not blocked[gate.logical_not()].any()
    # the whole queries over the split scene, kernels against plain
    hit = cutout.intersect_closest_cutout(scene, o, d, tmin, tmax)
    any_hit = cutout.intersect_any_cutout(scene, o, d, tmin, tmax)
    with plain_chains():
        want = cutout.intersect_closest_cutout(scene, o, d, tmin, tmax)
        want_any = cutout.intersect_any_cutout(scene, o, d, tmin, tmax)
    for k, a, b in zip(Hit._fields, hit, want):
        assert torch.equal(a, b), k
    assert torch.equal(any_hit, want_any)


def test_cutout_chain_launch_errors_raise(cuda):
    """Inputs the chain kernels do not take raise before any launch."""
    model, lights = stack_model()
    sub = flatten_model(model, lights, device=cuda).cutout_sub
    o, d, tmin, tmax = stack_rays([TIE_LANE] * 4, cuda)
    with pytest.raises(ValueError):
        cutout.closest_chain_kernel(sub, o.cpu(), d, tmin, tmax)
    with pytest.raises(ValueError):
        cutout.any_chain_kernel(sub, o, d, tmin, tmax,
                                torch.ones(3, dtype=torch.bool, device=cuda))


def test_hall_frame_cutout_kernels_equal_plain_chain(hall):
    """A whole 1080p hall frame through render_chunk with the chain
    kernels equals the frame whose chains are plain, bit for bit."""
    scene, params, kw = hall
    accum = torch.zeros(1080, 1920, 3, device=params[0].device)
    before = _chain_launches()
    img = path.render_chunk(scene, *params, 1920, 1080, accum, 0, 1, 2, **kw)
    assert _chain_launches() - before == 4
    with plain_chains():
        want = path.render_chunk(scene, *params, 1920, 1080, accum, 0, 1, 2,
                                 **kw)
    assert _chain_launches() - before == 4
    assert img.mean() > 0.005 and torch.equal(img, want)


def test_hall_small_gradients_cutout_kernels_equal_plain_chain(cuda):
    """Material-table gradients of hall_small at 32x32, frames 0-1 (every
    lobe, textures, the cutout chains through the kernels) equal those
    with the plain chain bit for bit: the kernels only choose the
    triangle, and the outer refine carries the gradient."""
    import dataclasses
    from optixpathtracer_tpu_torch.scene.flatten import (
        scene_active_lobes, scene_flat_shading, scene_uses_textures)
    model, camera, lights = PRESETS["hall_small"]()
    scene = flatten_model(model, lights, device=cuda)
    cam = camera.raygen_params(32, 32, cuda)
    flags = dict(active_lobes=scene_active_lobes(scene),
                 use_textures=scene_uses_textures(scene),
                 use_alpha_cutout=cutout.scene_uses_alpha_cutout(scene),
                 flat_shading=scene_flat_shading(scene))
    assert flags["use_alpha_cutout"]
    fields = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")

    def grads():
        params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
                  for f in fields}
        s = dataclasses.replace(scene, **params)
        loss = sum(path.render_sample(s, *cam, 32, 32, frame, 2, "auto",
                                      **flags).mean() for frame in (0, 1))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return {f: torch.zeros_like(p) if g is None else g
                for (f, p), g in zip(params.items(), grads)}

    before = _chain_launches()
    got = grads()
    assert _chain_launches() - before == 8
    with plain_chains():
        want = grads()
    assert _chain_launches() - before == 8
    for field, g in got.items():
        assert torch.isfinite(g).all() and torch.equal(g, want[field]), field
    assert got["mat_albedo"].abs().max() > 0
