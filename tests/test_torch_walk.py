"""Port parity of the walk engine: its plain PyTorch versions (what the
CUDA kernels in csrc/walk_intersect.cu compute, run here on the CPU)
against the JAX package's walk kernels in Pallas interpret mode and its
brute-force oracle, on the multi-chunk spheres-over-floor scene of
tests/test_walk_intersect.py carried across with `scene_from_jax`, so both
packages query the same arrays."""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optixpathtracer_tpu.intersect import brute as jbrute
from optixpathtracer_tpu.intersect import walk_kernels as jwalk
from optixpathtracer_tpu.scene import Material, Model, PointLight
from optixpathtracer_tpu.scene import flatten as jflatten_mod
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import quad, uv_sphere
from optixpathtracer_tpu_torch.intersect import api, brute, walk_kernels
from optixpathtracer_tpu_torch.scene import flatten_model, scene_from_jax

from test_walk_intersect import _make

torch.set_num_threads(1)


def jax_leaves(jscene):
    return {k: None if v is None else np.asarray(v)
            for k, v in jscene._asdict().items()}


def _scattered(n, seed, lo=(-3, 0.05, -3), hi=(3, 4, 3)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def walk_case():
    """(JAX scene, port scene, o, d): the 40x24 primary wavefront first,
    then 2048 scattered rays (~3k rays)."""
    jscene, o, d = _make()
    o2, d2 = _scattered(2048, 7)
    o = np.concatenate([np.asarray(o), o2])
    d = np.concatenate([np.asarray(d), d2])
    return jscene, scene_from_jax(jax_leaves(jscene), device="cpu"), o, d


# The JAX walk in interpret mode costs ~15 s per 1024-ray block on this
# CPU, so it sees one block per query (the primaries plus a few other
# rays); brute checks every ray.
N_PRIMARY = 40 * 24


def _mixed_tmax(n):
    """Per-ray tmax: mostly 100, every 5th 4.2 (short of some of the
    spheres the primaries see), every 11th dead (-1)."""
    tmax = np.full(n, 100.0, np.float32)
    tmax[::5] = 4.2
    tmax[::11] = -1.0
    return tmax


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_walk_closest(jscene, o, d, tmax):
    with pltpu.force_tpu_interpret_mode():
        got = jwalk.intersect_closest(jscene, o, d, 0.0, tmax)
    return {k: np.asarray(v) for k, v in got._asdict().items()}


def _assert_hits_equal(got, want, tmax):
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, want["hit"])
    np.testing.assert_array_equal(got.tri_id.numpy(), want["tri_id"])
    np.testing.assert_allclose(got.t.numpy()[hit], want["t"][hit], rtol=1e-5)
    np.testing.assert_array_equal(got.t.numpy()[~hit],
                                  np.broadcast_to(np.float32(tmax),
                                                  hit.shape)[~hit])


def test_scene_is_multichunk(walk_case):
    _, scene, o, _ = walk_case
    assert scene.walk_tris.shape[0] >= 8 and scene.walk_chunk == 128
    assert o.shape[0] > 2 * 1024


def test_chunk_boxes_equal(walk_case):
    jscene, scene, _, _ = walk_case
    jbox, c, chunk = jwalk._chunk_boxes(jscene)
    want = np.concatenate([np.asarray(b) for b in jbox], axis=0)
    got = walk_kernels._chunk_boxes(scene)
    assert got.dtype == torch.float32 and got.shape == (6, c)
    np.testing.assert_array_equal(got.numpy(), want)
    assert walk_kernels._chunk_boxes(scene) is got  # cached


def test_coherence_perm_identical(walk_case):
    jscene, scene, o, d = walk_case
    want = np.asarray(jwalk._coherence_perm(jscene, o, d))
    got = walk_kernels._coherence_perm(scene, _t(o), _t(d))
    np.testing.assert_array_equal(got.numpy(), want)


def _sorted_rays(jscene, o, d, tmax):
    perm = np.asarray(jwalk._coherence_perm(jscene, o, d))
    tmax = np.broadcast_to(np.float32(tmax), (o.shape[0],))
    return o[perm], d[perm], np.zeros(o.shape[0], np.float32), tmax[perm]


@pytest.mark.parametrize("tmax", ["100", "mixed"])
def test_candidates_match_reference(walk_case, tmax):
    """entry / cand / tnear / count at the reference's 1024-ray block (one
    block of primaries and scattered rays: the interpret-mode kernel costs
    ~6 s a block here), identical to the Pallas candidate kernel's after
    the reference's own sort; dead lanes take no part."""
    jscene, scene, o, d = walk_case
    o = np.concatenate([o[:512], o[-512:]])
    d = np.concatenate([d[:512], d[-512:]])
    tmax = _mixed_tmax(1024) if tmax == "mixed" else np.float32(100.0)
    so, sd, stmin, stmax = _sorted_rays(jscene, o, d, tmax)
    _, n_chunks, chunk = jwalk._chunk_boxes(jscene)
    rays, r, g, n_groups = jwalk._prep_rays(so, sd, stmin, stmax, n_chunks,
                                            chunk)
    assert n_groups == 1 and jwalk.RAY_SUB * jwalk.LANES == 1024
    with pltpu.force_tpu_interpret_mode():
        jcand, jtnear, jcount, _ = jwalk._candidates(jscene,
                                                     [p[0] for p in rays], g)
    entry = walk_kernels.candidates_plain(
        walk_kernels._chunk_boxes(scene), _t(so), _t(sd), _t(stmin),
        _t(np.ascontiguousarray(stmax)), block_rays=1024)
    cand, tnear, count = walk_kernels.sort_candidates(entry)
    assert cand.shape[0] == 1
    assert cand.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand)[:1])
    np.testing.assert_array_equal(tnear.numpy(), np.asarray(jtnear)[:1])
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount)[:1, 0])
    assert (count.numpy() > 0).all()


def test_walk_closest_matches_reference(walk_case):
    """Primary rays with tmax 100, 4.2 and dead lanes against the JAX walk
    in interpret mode."""
    jscene, scene, o, d = walk_case
    o, d = o[:N_PRIMARY], d[:N_PRIMARY]
    tmax = _mixed_tmax(N_PRIMARY)
    got = walk_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, _t(tmax))
    hit = got.hit.numpy()
    short = tmax == np.float32(4.2)
    assert 0 < hit[short].mean() < hit[tmax == 100.0].mean()
    assert (got.t.numpy()[short] <= np.float32(4.2)).all()
    assert not hit[tmax < 0].any()
    _assert_hits_equal(got, _jax_walk_closest(jscene, o, d, tmax), tmax)


@pytest.mark.parametrize("tmax", [100.0, 1.0])
def test_walk_closest_matches_brute(walk_case, tmax):
    jscene, scene, o, d = walk_case
    got = walk_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, tmax)
    hit = got.hit.numpy()
    assert 0 < hit.sum() < len(hit)
    oracle = jbrute.intersect_closest(jscene, o, d, 0.0, tmax)
    _assert_hits_equal(got, {k: np.asarray(v)
                             for k, v in oracle._asdict().items()}, tmax)


def test_walk_closest_dead_lanes_and_raw_misses(walk_case):
    _, scene, o, d = walk_case
    tmax = _mixed_tmax(o.shape[0])
    t, tri_id = walk_kernels.intersect_closest_raw(scene, _t(o), _t(d), 0.0,
                                                   _t(tmax))
    assert tri_id.dtype == torch.int32
    assert (tri_id.numpy()[::11] == -1).all()
    miss = tri_id.numpy() < 0
    np.testing.assert_array_equal(t.numpy()[miss], np.float32(3.4e38))
    want = brute.intersect_closest(scene, _t(o), _t(d), 0.0, _t(tmax))
    np.testing.assert_array_equal(tri_id.numpy(), want.tri_id.numpy())


def _shadow_rays(jscene, o, d, seed):
    """Shadow-style rays: from points on the surfaces (offset 1e-3) in
    random directions."""
    hit = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    m = np.asarray(hit.hit)
    pts = o[m] + np.asarray(hit.t)[m, None] * d[m]
    _, dirs = _scattered(pts.shape[0], seed)
    return (pts + 1e-3 * dirs).astype(np.float32), dirs


def test_walk_any_matches_reference_and_brute(walk_case):
    """Primary rays with per-ray tmax and dead lanes, then shadow-style
    rays: against the JAX walk in interpret mode on one block, and against
    brute on every ray."""
    jscene, scene, o, d = walk_case
    so, sd = _shadow_rays(jscene, o, d, 1)
    o = np.concatenate([o, so])
    d = np.concatenate([d, sd])
    tmax = np.linspace(0.1, 8.0, o.shape[0]).astype(np.float32)
    tmax[::17] = -1.0
    tmax[-so.shape[0]:] = 10.0
    got = walk_kernels.intersect_any(scene, _t(o), _t(d), 0.0,
                                     _t(tmax)).numpy()
    assert got.dtype == np.bool_ and 0 < got.sum() < len(got)
    assert not got[:-so.shape[0]][::17].any()
    assert 0 < got[-so.shape[0]:].sum() < so.shape[0]
    oracle = np.asarray(jbrute.intersect_any(jscene, o, d, 0.0, tmax))
    np.testing.assert_array_equal(got, oracle)
    one = np.r_[0:N_PRIMARY, o.shape[0] - 64:o.shape[0]]  # 1024 rays
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jwalk.intersect_any(jscene, o[one], d[one], 0.0,
                                              tmax[one]))
    np.testing.assert_array_equal(
        walk_kernels.intersect_any(scene, _t(o[one]), _t(d[one]), 0.0,
                                   _t(tmax[one])).numpy(), want)


@pytest.mark.parametrize("block_rays", walk_kernels.BLOCK_SIZES)
def test_block_size_does_not_change_hits(walk_case, block_rays):
    _, scene, o, d = walk_case
    want = brute.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0)
    got = walk_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0,
                                         block_rays=block_rays)
    np.testing.assert_array_equal(got.tri_id.numpy(), want.tri_id.numpy())
    blocked = walk_kernels.intersect_any(scene, _t(o), _t(d), 0.0, 3.0,
                                         block_rays=block_rays)
    np.testing.assert_array_equal(
        blocked.numpy(), brute.intersect_any(scene, _t(o), _t(d), 0.0,
                                             3.0).numpy())


def _duplicated_scene():
    """The spheres-over-floor scene with three spheres added twice more,
    coincident with one of the grid's: duplicate triangles, some pairs in
    different walk chunks."""
    mat = Material(mat_type="diffuse")
    meshes = [quad((-6.0, 0.0, -6.0), (0.0, 0.0, 12.0), (12.0, 0.0, 0.0),
                   mat)]
    centers = [(np.array([i, j, k], np.float64) - 0.5) * 1.2 + [0, 2, 0]
               for i in range(2) for j in range(2) for k in range(2)]
    for c in centers + centers[:3]:
        meshes.append(uv_sphere(0.4, tuple(c), 6, 12, mat))
    return jflatten(Model(meshes=meshes),
                    [PointLight(np.array([2.0, 5.0, 1.0]), np.ones(3))])


def _twins(scene):
    """(lower id, higher id) of every pair of coincident real triangles."""
    v0, e1, e2 = (x.numpy() for x in (scene.tri_v0, scene.tri_e1,
                                       scene.tri_e2))
    seen, pairs = {}, []
    for i in np.nonzero(scene.tri_valid.numpy())[0]:
        key = (v0[i].tobytes(), e1[i].tobytes(), e2[i].tobytes())
        if key in seen:
            pairs.append((seen[key], i))
        else:
            seen[key] = i
    return np.array(pairs)


def test_coincident_triangles_lowest_id_wins():
    """Rays straight at coincident pairs (from just outside along the
    normal): the walk, the JAX walk and brute all report the lower id,
    also where the twins lie in different chunks."""
    jscene = _duplicated_scene()
    scene = scene_from_jax(jax_leaves(jscene), device="cpu")
    pairs = _twins(scene)
    chunk = scene.walk_chunk
    across = pairs[pairs[:, 0] // chunk != pairs[:, 1] // chunk]
    assert len(across) >= 1 and len(pairs) > len(across)
    ids = pairs[:, 0]
    v0, e1, e2 = (x.numpy()[ids] for x in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2))
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centroid = v0 + (e1 + e2) / 3.0
    o = (centroid + 0.05 * n).astype(np.float32)
    d = (-n).astype(np.float32)
    got = walk_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0)
    np.testing.assert_array_equal(got.tri_id.numpy(), ids)
    _assert_hits_equal(got, _jax_walk_closest(jscene, o, d, 100.0), 100.0)
    want = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))


def test_chunk_256(monkeypatch):
    """MAX_WALK_CHUNKS cut so the scene packs 256 triangles a chunk (the
    hall case): the plain sweep takes whole 256-triangle chunks, the JAX
    walk and brute agree."""
    from optixpathtracer_tpu_torch.scene import flatten as tflatten_mod
    monkeypatch.setattr(jflatten_mod, "MAX_WALK_CHUNKS", 5)
    monkeypatch.setattr(tflatten_mod, "MAX_WALK_CHUNKS", 5)
    jscene, o, d = _make()
    o, d = np.asarray(o), np.asarray(d)
    scene = scene_from_jax(jax_leaves(jscene), device="cpu")
    assert scene.walk_chunk == 256 and scene.walk_tris.shape[0] >= 2
    got = walk_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0)
    _assert_hits_equal(got, _jax_walk_closest(jscene, o, d, 100.0), 100.0)
    want = jbrute.intersect_closest(jscene, o, d, 0.0, 100.0)
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    # the port's own flatten builds the same 256-triangle layout
    tscene = flatten_model(*_walk_model(), device="cpu")
    np.testing.assert_array_equal(tscene.walk_tris.numpy(),
                                  scene.walk_tris.numpy())


def _walk_model():
    from optixpathtracer_tpu_torch.scene import Material as TMaterial
    from optixpathtracer_tpu_torch.scene import Model as TModel
    from optixpathtracer_tpu_torch.scene import PointLight as TPointLight
    from optixpathtracer_tpu_torch.scene.procedural import (quad as tquad,
                                                            uv_sphere as tsph)
    mat = TMaterial(mat_type="diffuse")
    meshes = [tquad((-6.0, 0.0, -6.0), (0.0, 0.0, 12.0), (12.0, 0.0, 0.0),
                    mat)]
    for i in range(2):
        for j in range(2):
            for k in range(2):
                c = (np.array([i, j, k], np.float64) - 0.5) * 1.2
                c[1] += 2.0
                meshes.append(tsph(0.4, tuple(c), 6, 12, mat))
    return TModel(meshes=meshes), [TPointLight(np.array([2.0, 5.0, 1.0]),
                                               np.ones(3))]


def test_api_routes_walk_and_bvh(walk_case):
    _, scene, o, d = walk_case
    assert scene.tri_v0.shape[0] <= api.BRUTE_FORCE_MAX_TRIS
    assert api._resolve("auto", scene, "cuda") == "walk"
    assert api._resolve("auto:bounce", scene, torch.device("cuda", 0)) \
        == "walk"
    assert api._resolve("auto", scene, "cpu") == "brute"
    got = api.intersect_closest(scene, _t(o), _t(d), method="walk")
    want = api.intersect_closest(scene, _t(o), _t(d), method="brute")
    for k in ("hit", "tri_id", "back_face"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy())
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), atol=1e-6)
    packet = api.intersect_closest(scene, _t(o), _t(d), method="packet")
    for k in ("hit", "tri_id", "back_face"):
        np.testing.assert_array_equal(getattr(packet, k).numpy(),
                                      getattr(want, k).numpy())


def test_unwalkable_scene_raises():
    model, lights = _walk_model()
    scene = flatten_model(model, lights, build_bvh=False, device="cpu")
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(4, 3).contiguous()
    with pytest.raises(ValueError, match="build_bvh"):
        walk_kernels.intersect_closest(scene, o, d)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(walk_case):
    """CPU tensors, wrong dtypes and shapes are refused before any pointer
    reaches a kernel, and nothing is counted."""
    _, scene, o, d = walk_case
    boxes = walk_kernels._chunk_boxes(scene)
    rays = (_t(o), _t(d), torch.zeros(o.shape[0]),
            torch.full((o.shape[0],), 100.0))
    cand, tnear, count = walk_kernels.sort_candidates(
        walk_kernels.candidates_plain(boxes, *rays))
    counts = (walk_kernels.candidates_kernel.launches,
              walk_kernels.closest_kernel.launches,
              walk_kernels.any_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernels.candidates_kernel(boxes, *rays)
    with pytest.raises(ValueError):
        walk_kernels.candidates_kernel(boxes, *rays, block_rays=100)
    with pytest.raises(ValueError, match="CUDA"):
        walk_kernels.closest_kernel(scene.walk_tris, boxes, cand, tnear,
                                    count, *rays)
    with pytest.raises(ValueError):
        walk_kernels.any_kernel(scene.walk_tris, boxes, cand.long(), count,
                                *rays)
    assert counts == (walk_kernels.candidates_kernel.launches,
                      walk_kernels.closest_kernel.launches,
                      walk_kernels.any_kernel.launches)


# ---------------------------------------------------------------------------
# The needed-work count model (walk_kernels.needed_work), the sweeps' bound
# ---------------------------------------------------------------------------

def _np_inv(d):
    tiny = np.where(d >= 0, np.float32(1e-20), np.float32(-1e-20))
    return np.float32(1.0) / np.where(np.abs(d) < np.float32(1e-20), tiny, d)


def _np_slab(o, inv, tmin, limit, box):
    """The kernels' slab test of one ray against one box, in float32."""
    t0 = (box[:3] - o) * inv
    t1 = (box[3:] - o) * inv
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    t_near = max(max(lo[0], lo[1]), lo[2])
    t_far = min(min(hi[0], hi[1]), hi[2])
    return t_near <= t_far and t_far >= tmin and t_near <= limit


def _np_mt(o, d, tmin, tmax, tri):
    """Moller-Trumbore of one ray against the [9, chunk] triangle rows of
    one chunk, in the kernels' operation order, in float32: (t, hit,
    stage), stage 0 where u rules the hit out (or |det| is too small), 1
    where v then does, 2 where the test goes on to t."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = d[1] * e2z - d[2] * e2y
    pvy = d[2] * e2x - d[0] * e2z
    pvz = d[0] * e2y - d[1] * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = np.abs(det) > np.float32(1e-12)
    inv_det = np.where(ok, np.float32(1.0) / np.where(ok, det, 1), 0)
    tvx, tvy, tvz = o[0] - v0x, o[1] - v0y, o[2] - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin) & (t < tmax)
    in_u = ok & (u >= 0) & (u <= 1)
    stage = in_u.astype(np.int64) + (in_u & (v >= 0) & (u + v <= 1))
    return t.astype(np.float32), hit, stage


def _walk_query(scene, o, d, tmax, block_rays=256):
    """Coherence-sorted rays (tmin 0) and their sorted candidates, through
    the port's plain versions: (rays, boxes, cand, tnear, count)."""
    o, d = _t(o), _t(d)
    tmax = torch.tensor(np.broadcast_to(np.float32(tmax), (o.shape[0],)))
    perm = walk_kernels._coherence_perm(scene, o, d)
    rays = tuple(x[perm].contiguous()
                 for x in (o, d, torch.zeros(o.shape[0]), tmax))
    boxes = walk_kernels._chunk_boxes(scene)
    entry = walk_kernels.candidates_plain(boxes, *rays, block_rays)
    return (rays, boxes) + walk_kernels.sort_candidates(entry)


def _literal_counts(kind, scene, query, block_rays=256, old=False):
    """Per block (tests, chunks, exits [n_blocks, 3]: the tests by where
    they can end, `_np_mt`'s stage), by a literal loop over each block's
    candidates in list order and each of its rays, with the sweeps' early
    exits. old=True counts as a one-thread-per-ray sweep's counter charges:
    a chunk some ray passes runs on every warp with a passing lane,
    closest lanes test all chunk slots, occlusion lanes every slot until
    their first blocker (padding included). Also asserts that the early exit only ever skips
    chunks no ray's own slab test passes."""
    rays, boxes, cand, tnear, count = query
    o, d, tmin, tmax = (x.numpy() for x in rays)
    walk = scene.walk_tris.numpy()
    real = (walk[:, 3:9] != 0).any(axis=1)
    box = boxes.numpy()
    inv = _np_inv(d)
    nb = cand.shape[0]
    tests, chunks = np.zeros(nb, np.int64), np.zeros(nb, np.int64)
    exits = np.zeros((nb, 3), np.int64)
    for b in range(nb):
        idx = range(b * block_rays, min((b + 1) * block_rays, o.shape[0]))
        best = {i: np.float32(3.4e38) for i in idx}
        blocked = {i: False for i in idx}
        for j in range(int(count[b])):
            c = int(cand[b, j])
            limit = {i: min(best[i], tmax[i]) if kind == "closest"
                     else tmax[i] for i in idx}
            passes = [i for i in idx
                      if tmax[i] > tmin[i] and not blocked[i]
                      and _np_slab(o[i], inv[i], tmin[i], limit[i], box[:, c])]
            # the kernels' early exits; dead padding lanes carry tmax = -1
            pad = -1.0 if len(idx) < block_rays else -np.inf
            if kind == "closest":
                stop = j > 0 and tnear[b, j] > max(max(limit.values()), pad)
            else:
                stop = not any(tmax[i] > tmin[i] and not blocked[i]
                               for i in idx)
            if stop:
                assert not passes, (b, j)
                break
            if not passes:
                continue
            chunks[b] += 1
            runs = passes
            if old:  # every lane of a warp with a passing lane runs
                warps = {(i - b * block_rays) // 32 for i in passes}
                runs = [i for i in idx if (i - b * block_rays) // 32 in warps
                        and (kind == "closest" or (tmax[i] > tmin[i]
                                                   and not blocked[i]))]
                # and padding lanes of such warps run too
                pad_lanes = sum(
                    1 for w in warps
                    for lane in range(32)
                    if b * block_rays + 32 * w + lane >= o.shape[0])
                if kind == "closest":
                    tests[b] += pad_lanes * walk.shape[2]
            for i in runs:
                t, hit, stage = _np_mt(o[i], d[i], tmin[i], tmax[i],
                                       walk[c, :9])
                hit_real = hit & real[c]
                ran = real[c].copy()
                if kind == "closest":
                    tests[b] += walk.shape[2] if old else int(real[c].sum())
                    if hit_real.any():
                        best[i] = min(best[i], t[hit_real].min())
                else:
                    slots = hit if old else hit_real
                    if slots.any():
                        first = int(np.argmax(slots))
                        tests[b] += (first + 1 if old
                                     else int(real[c][:first + 1].sum()))
                        blocked[i] = True
                        ran[first + 1:] = False
                    else:
                        tests[b] += (walk.shape[2] if old
                                     else int(real[c].sum()))
                exits[b] += np.bincount(stage[ran], minlength=3)
    return tests, chunks, exits


_WORK_TMAX = {"mixed": _mixed_tmax, "1.0": lambda n: np.where(
    np.arange(n) % 11 == 0, np.float32(-1.0), np.float32(1.0))}


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("tmax", sorted(_WORK_TMAX))
def test_needed_work_matches_a_literal_loop(walk_case, kind, tmax):
    """The count model against a per-ray, per-candidate loop, with dead
    lanes (every 11th ray) and short rays, and never above what a
    one-thread-per-ray sweep's counter charges."""
    _, scene, o, d = walk_case
    query = _walk_query(scene, o, d, _WORK_TMAX[tmax](o.shape[0]))
    rays, boxes, cand, tnear, count = query
    tests, chunks, exits, below, above = walk_kernels.needed_work(
        kind, scene.walk_tris, boxes, cand, tnear, count, *rays)
    want_tests, want_chunks, want_exits = _literal_counts(kind, scene, query)
    np.testing.assert_array_equal(tests.numpy(), want_tests)
    np.testing.assert_array_equal(chunks.numpy(), want_chunks)
    np.testing.assert_array_equal(exits.numpy(), want_exits)
    assert tests.dtype == torch.int64 and tests.sum() > 0
    assert (chunks <= count).all()
    # every way a test can end occurs in this scene
    assert (exits.sum(dim=0) > 0).all()
    old_tests, old_chunks, _ = _literal_counts(kind, scene, query, old=True)
    assert (tests.numpy() <= old_tests).all()
    np.testing.assert_array_equal(chunks.numpy(), old_chunks)
    assert (below >= 0).all() and (above >= 0).all()
    if kind == "any":
        assert (below <= tests).all() and (above + below).sum() > 0
    else:
        assert not below.any() and not above.any()


def _merge_key(t, tri_id):
    """The CUDA sweeps' merge key of a hit, as uint64: t's float32 bits
    mapped to an order-preserving uint32 in the high word, the id in the
    low word; the lowest key is the nearest hit, lowest id at equal t."""
    bits = np.asarray(t, np.float32).view(np.uint32).astype(np.uint64)
    ordered = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF,
                       bits | 0x80000000)
    return (ordered << np.uint64(32)) | np.asarray(tri_id).astype(np.uint64)


def test_coincident_triangles_merge_to_the_lowest_id():
    """Coincident triangles in two candidate chunks: the kernels' merge
    rule (the lowest key over every warp's slice of every swept chunk, in
    whatever order they finish) gives the plain sweep's (t, lowest id), and
    so does the plain sweep over the candidates in reverse order."""
    jscene = _duplicated_scene()
    scene = scene_from_jax(jax_leaves(jscene), device="cpu")
    pairs = _twins(scene)
    chunk = scene.walk_chunk
    across = pairs[pairs[:, 0] // chunk != pairs[:, 1] // chunk]
    assert len(across) >= 1
    v0, e1, e2 = (x.numpy()[across[:, 0]] for x in (
        scene.tri_v0, scene.tri_e1, scene.tri_e2))
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    o = (v0 + (e1 + e2) / 3.0 + 0.05 * n).astype(np.float32)
    d = (-n).astype(np.float32)
    rays, boxes, cand, tnear, count = _walk_query(scene, o, d, 100.0)
    t, tri_id = walk_kernels.closest_plain(scene.walk_tris, cand, count,
                                           *rays)
    assert (tri_id.numpy() >= 0).all()
    back = torch.stack([torch.cat([row[:k].flip(0), row[k:]])
                        for row, k in zip(cand, count.tolist())])
    t_back, id_back = walk_kernels.closest_plain(scene.walk_tris, back,
                                                 count, *rays)
    assert torch.equal(id_back, tri_id) and torch.equal(t_back, t)
    # every slice (an eighth of a chunk, as a warp sweeps it) of every
    # candidate chunk reports its own nearest, lowest-id hit; merged
    # last-to-first, the lowest key is the plain sweep's answer
    o_s, d_s, tmin_s, tmax_s = (x.numpy() for x in rays)
    walk = scene.walk_tris.numpy()
    rng = np.random.default_rng(0)
    for i in range(o_s.shape[0]):
        b = i // walk_kernels.BLOCK_RAYS
        keys = []
        for c in cand[b, :int(count[b])].tolist():
            th, hit, _ = _np_mt(o_s[i], d_s[i], tmin_s[i], tmax_s[i],
                                walk[c, :9])
            for s0 in range(0, chunk, chunk // 8):
                sl = np.nonzero(hit[s0:s0 + chunk // 8])[0]
                if sl.size:
                    k = s0 + sl[np.argmin(th[s0 + sl])]  # lowest id on ties
                    keys.append(_merge_key(th[k], c * chunk + k))
        keys = np.array(keys, np.uint64)[rng.permutation(len(keys))]
        best = keys.min()
        # a tie: the other twin's slice reports the same t, a higher id
        assert ((keys >> np.uint64(32)) == (best >> np.uint64(32))).sum() >= 2
        assert (best & 0xFFFFFFFF) == int(tri_id[i])
        assert (np.uint32(best >> np.uint64(32)) ^ np.uint32(0x80000000)
                ).view(np.float32) == t[i].numpy()
    # the rays are in coherence order: each twin pair's lower id, once
    np.testing.assert_array_equal(np.sort(tri_id.numpy()),
                                  np.sort(across[:, 0]))
