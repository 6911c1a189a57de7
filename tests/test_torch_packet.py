"""Port parity of the packet engine: its plain PyTorch versions (what the
CUDA kernels in csrc/packet_intersect.cu compute, run here on the CPU)
against the JAX package's packet engine (`_packet_words`, and its Pallas
sweeps in interpret mode) and its brute-force oracle, on the multi-chunk
spheres-over-floor scene of tests/test_walk_intersect.py carried across
with `scene_from_jax`, so both packages query the same arrays."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from optixpathtracer_tpu.intersect import brute as jbrute
from optixpathtracer_tpu.intersect import packet_kernels as jpacket
from optixpathtracer_tpu.intersect import walk_kernels as jwalk
from optixpathtracer_tpu.scene import flatten as jflatten_mod
from optixpathtracer_tpu_torch.intersect import (api, brute, packet_kernels,
                                                 walk_kernels)
from optixpathtracer_tpu_torch.scene import scene_from_jax

from test_torch_walk import (N_PRIMARY, _assert_hits_equal, _duplicated_scene,
                             _mixed_tmax, _scattered, _shadow_rays, _t,
                             _twins, jax_leaves)
from test_walk_intersect import _make

torch.set_num_threads(1)

BLOCK = 1024  # the reference's packet block: 128 packets of 8 rays


@pytest.fixture(scope="module")
def packet_case():
    """(JAX scene, port scene, o, d): the 40x24 primary wavefront first,
    then 2048 scattered rays (~3k rays)."""
    jscene, o, d = _make()
    o2, d2 = _scattered(2048, 7)
    o = np.concatenate([np.asarray(o), o2])
    d = np.concatenate([np.asarray(d), d2])
    return jscene, scene_from_jax(jax_leaves(jscene), device="cpu"), o, d


def _one_block(o, d):
    """1024 rays: half primaries, half scattered."""
    return np.concatenate([o[:512], o[-512:]]), np.concatenate([d[:512],
                                                                d[-512:]])


def _sorted_block(jscene, scene, o, d, tmax):
    """One 1024-ray block sorted by the reference's coherence key, and the
    port's candidates of it: (rays, (cand, tnear, count))."""
    perm = np.asarray(jwalk._coherence_perm(jscene, o, d))
    tmax = np.broadcast_to(np.float32(tmax), (o.shape[0],))[perm]
    rays = (o[perm], d[perm], np.zeros(o.shape[0], np.float32), tmax)
    entry = walk_kernels.candidates_plain(walk_kernels._chunk_boxes(scene),
                                          *map(_t, rays), block_rays=BLOCK)
    return rays, walk_kernels.sort_candidates(entry)


def _port_words(scene, rays, cand, tnear):
    return packet_kernels.packet_words_plain(
        scene.walk_sub_box, cand, tnear, *map(_t, rays), scene.walk_chunk,
        BLOCK)


def _assert_words_equal(got, want):
    words, w0, w1 = got
    jwords, jw0, jw1 = (np.asarray(x) for x in want)
    assert words.dtype == w0.dtype == w1.dtype == torch.int32
    assert words.shape[:2] == (1, 128)
    np.testing.assert_array_equal(words.numpy(),
                                  jwords[:, :, :words.shape[2]])
    assert not jwords[:, :, words.shape[2]:].any()  # lane padding only
    np.testing.assert_array_equal(w0.numpy(), jw0)
    np.testing.assert_array_equal(w1.numpy(), jw1)
    assert (words != 0).any() and (words == 0).any()


def test_packet_words_match_reference(packet_case):
    """Words, w0 and w1 bit-identical to the reference's `_packet_words`,
    fed from its `_prep_rays_packet` and its Pallas candidate kernel in
    interpret mode on one 1024-ray block, under mixed tmax (4.2, 100 and
    dead lanes)."""
    jscene, scene, o, d = packet_case
    o, d = _one_block(o, d)
    rays, (cand, tnear, count) = _sorted_block(jscene, scene, o, d,
                                               _mixed_tmax(BLOCK))
    _, n_chunks, chunk = jwalk._chunk_boxes(jscene)
    trav, rall, _, g, n_groups = jpacket._prep_rays_packet(*rays, n_chunks,
                                                           chunk)
    assert n_groups == 1 and g == 1
    with pltpu.force_tpu_interpret_mode():
        jcand, jtnear, _, maxc_pad = jwalk._candidates(
            jscene, [p[0] for p in trav], g)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    want = jpacket._packet_words(jscene, rall[0], jcand, jtnear, g, maxc_pad)
    _assert_words_equal(_port_words(scene, rays, cand, tnear), want)


def _chunk256_case(monkeypatch):
    from optixpathtracer_tpu_torch.scene import flatten as tflatten_mod
    monkeypatch.setattr(jflatten_mod, "MAX_WALK_CHUNKS", 5)
    monkeypatch.setattr(tflatten_mod, "MAX_WALK_CHUNKS", 5)
    jscene, o, d = _make()
    o2, d2 = _scattered(512, 3)
    o = np.concatenate([np.asarray(o), o2])
    d = np.concatenate([np.asarray(d), d2])
    scene = scene_from_jax(jax_leaves(jscene), device="cpu")
    assert scene.walk_chunk == 256 and scene.walk_tris.shape[0] >= 2
    return jscene, scene, o, d


def test_packet_chunk_256(monkeypatch):
    """Two subchunks a chunk (hall's layout): words bit-identical to the
    reference's `_packet_words` on the same candidates, hits and blocked
    flags equal to brute's on every ray."""
    jscene, scene, o, d = _chunk256_case(monkeypatch)
    rays, (cand, tnear, _) = _sorted_block(jscene, scene, *_one_block(o, d),
                                           100.0)
    _, n_chunks, chunk = jwalk._chunk_boxes(jscene)
    _, rall, _, g, _ = jpacket._prep_rays_packet(*rays, n_chunks, chunk)
    want = jpacket._packet_words(jscene, rall[0], jnp.asarray(cand.numpy()),
                                 jnp.asarray(tnear.numpy()), g, cand.shape[1])
    _assert_words_equal(_port_words(scene, rays, cand, tnear), want)
    tmax = _mixed_tmax(o.shape[0])
    got = packet_kernels.intersect_closest(scene, _t(o), _t(d), 0.0,
                                           _t(tmax))
    oracle = jbrute.intersect_closest(jscene, o, d, 0.0, tmax)
    _assert_hits_equal(got, {k: np.asarray(v)
                             for k, v in oracle._asdict().items()}, tmax)
    np.testing.assert_array_equal(
        packet_kernels.intersect_any(scene, _t(o), _t(d), 0.0,
                                     _t(tmax)).numpy(),
        np.asarray(jbrute.intersect_any(jscene, o, d, 0.0, tmax)))


def test_packet_closest_matches_reference_and_brute(packet_case):
    """Against the JAX packet engine in interpret mode on one block of
    primaries (tmax 100, 4.2 and dead lanes), and against brute on every
    ray."""
    jscene, scene, o, d = packet_case
    tmax = _mixed_tmax(o.shape[0])
    got = packet_kernels.intersect_closest(scene, _t(o), _t(d), 0.0,
                                           _t(tmax))
    hit = got.hit.numpy()
    short = tmax == np.float32(4.2)
    assert 0 < hit[short].mean() < hit[tmax == 100.0].mean()
    assert not hit[tmax < 0].any()
    oracle = jbrute.intersect_closest(jscene, o, d, 0.0, tmax)
    _assert_hits_equal(got, {k: np.asarray(v)
                             for k, v in oracle._asdict().items()}, tmax)
    one = slice(0, N_PRIMARY)
    with pltpu.force_tpu_interpret_mode():
        want = jpacket.intersect_closest(jscene, o[one], d[one], 0.0,
                                         tmax[one])
    got = packet_kernels.intersect_closest(scene, _t(o[one]), _t(d[one]),
                                           0.0, _t(tmax[one]))
    _assert_hits_equal(got, {k: np.asarray(v)
                             for k, v in want._asdict().items()}, tmax[one])


def test_packet_any_matches_reference_and_brute(packet_case):
    """Primary rays with per-ray tmax and dead lanes, then shadow-style
    rays: against the JAX packet engine in interpret mode on one block, and
    against brute on every ray."""
    jscene, scene, o, d = packet_case
    so, sd = _shadow_rays(jscene, o, d, 1)
    o = np.concatenate([o, so])
    d = np.concatenate([d, sd])
    tmax = np.linspace(0.1, 8.0, o.shape[0]).astype(np.float32)
    tmax[::17] = -1.0
    tmax[-so.shape[0]:] = 10.0
    got = packet_kernels.intersect_any(scene, _t(o), _t(d), 0.0,
                                       _t(tmax)).numpy()
    assert got.dtype == np.bool_ and 0 < got.sum() < len(got)
    assert not got[:-so.shape[0]][::17].any()
    np.testing.assert_array_equal(
        got, np.asarray(jbrute.intersect_any(jscene, o, d, 0.0, tmax)))
    one = np.r_[0:N_PRIMARY, o.shape[0] - 64:o.shape[0]]  # 1024 rays
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpacket.intersect_any(jscene, o[one], d[one], 0.0,
                                                tmax[one]))
    np.testing.assert_array_equal(got[one], want)


@pytest.mark.parametrize("block_rays", walk_kernels.BLOCK_SIZES)
def test_block_size_does_not_change_hits(packet_case, block_rays):
    _, scene, o, d = packet_case
    want = brute.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0)
    got = packet_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0,
                                           block_rays=block_rays)
    np.testing.assert_array_equal(got.tri_id.numpy(), want.tri_id.numpy())
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    blocked = packet_kernels.intersect_any(scene, _t(o), _t(d), 0.0, 3.0,
                                           block_rays=block_rays)
    np.testing.assert_array_equal(
        blocked.numpy(), brute.intersect_any(scene, _t(o), _t(d), 0.0,
                                             3.0).numpy())


def test_raw_misses_and_empty_packets(packet_case):
    """t = BIG, id = -1 on a miss; a packet whose rays are all dead has no
    bit set (w0 = 1, w1 = 0) and takes no test."""
    jscene, scene, o, d = packet_case
    tmax = _mixed_tmax(o.shape[0])
    tmax[:16] = -1.0  # unsorted below: the first two packets are dead
    t, tri_id = packet_kernels.intersect_closest_raw(scene, _t(o), _t(d),
                                                     0.0, _t(tmax))
    assert tri_id.dtype == torch.int32
    miss = tri_id.numpy() < 0
    np.testing.assert_array_equal(t.numpy()[miss], np.float32(3.4e38))
    assert (tri_id.numpy()[tmax < 0] == -1).all()
    rays = tuple(_t(x) for x in (o[:BLOCK], d[:BLOCK],
                                 np.zeros(BLOCK, np.float32), tmax[:BLOCK]))
    cand, tnear, _ = walk_kernels.sort_candidates(
        walk_kernels.candidates_plain(walk_kernels._chunk_boxes(scene),
                                      *rays, block_rays=BLOCK))
    words, w0, w1 = packet_kernels.packet_words_plain(
        scene.walk_sub_box, cand, tnear, *rays, scene.walk_chunk, BLOCK)
    assert not words[0, :2].any()
    assert w0[0, :2].tolist() == [1, 1] and w1[0, :2].tolist() == [0, 0]


def test_coincident_triangles_lowest_id_wins():
    """Rays straight at coincident pairs, some pairs in different chunks:
    the packet engine reports the lower id, as brute does."""
    jscene = _duplicated_scene()
    scene = scene_from_jax(jax_leaves(jscene), device="cpu")
    pairs = _twins(scene)
    ids = pairs[:, 0]
    v0, e1, e2 = (x.numpy()[ids] for x in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2))
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    o = (v0 + (e1 + e2) / 3.0 + 0.05 * n).astype(np.float32)
    d = (-n).astype(np.float32)
    got = packet_kernels.intersect_closest(scene, _t(o), _t(d), 0.0, 100.0)
    np.testing.assert_array_equal(got.tri_id.numpy(), ids)


def test_api_packet_method_and_routing(packet_case):
    """method="packet" through the API equals brute; on CUDA, "auto:bounce"
    routes scenes of at least PACKET_BOUNCE_MIN_CHUNKS walk chunks to the
    packet engine and "auto" keeps the walk engine."""
    _, scene, o, d = packet_case
    got = api.intersect_closest(scene, _t(o), _t(d), method="packet")
    want = api.intersect_closest(scene, _t(o), _t(d), method="brute")
    for k in ("hit", "tri_id", "back_face"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy())
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        api.intersect_any(scene, _t(o), _t(d), 0.0, 3.0,
                          method="packet").numpy(),
        api.intersect_any(scene, _t(o), _t(d), 0.0, 3.0,
                          method="brute").numpy())

    def stub(n_chunks):  # what _resolve reads of a scene
        return types.SimpleNamespace(walk_tris=torch.empty(n_chunks, 16, 0),
                                     tri_v0=torch.empty(n_chunks * 256, 3))

    big, under = stub(api.PACKET_BOUNCE_MIN_CHUNKS), stub(511)
    cuda = torch.device("cuda", 0)
    assert api._resolve("auto:bounce", big, cuda) == "packet"
    assert api._resolve("auto", big, cuda) == "walk"
    assert api._resolve("auto:bounce", under, "cuda") == "walk"
    assert api._resolve("auto:bounce", big, "cpu") == "bvh"
    assert api._resolve("packet", scene, "cpu") == "packet"


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(packet_case):
    """CPU tensors, wrong dtypes and shapes are refused before any pointer
    reaches a kernel, and nothing is counted."""
    _, scene, o, d = packet_case
    rays = (_t(o), _t(d), torch.zeros(o.shape[0]),
            torch.full((o.shape[0],), 100.0))
    cand, tnear, count = walk_kernels.sort_candidates(
        walk_kernels.candidates_plain(walk_kernels._chunk_boxes(scene),
                                      *rays))
    args = (scene.walk_tris, scene.walk_sub_box, cand, tnear, count)
    counts = (packet_kernels.packet_closest_kernel.launches,
              packet_kernels.packet_any_kernel.launches)
    for kernel in (packet_kernels.packet_closest_kernel,
                   packet_kernels.packet_any_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args, *rays)
        with pytest.raises(ValueError):
            kernel(*args[:2], cand.long(), *args[3:], *rays)
        with pytest.raises(ValueError):
            kernel(*args, *rays, block_rays=100)
    assert counts == (packet_kernels.packet_closest_kernel.launches,
                      packet_kernels.packet_any_kernel.launches)


def _walk_shape(n_tris):
    """(chunk, maxc_pad) of the walk layout `flatten` builds for n_tris
    triangles."""
    from optixpathtracer_tpu_torch.scene import flatten as tflatten_mod
    t_pad = -(-n_tris // tflatten_mod.PAD_MULTIPLE) * tflatten_mod.PAD_MULTIPLE
    chunk = tflatten_mod._walk_chunk_size(t_pad)
    n_chunks = -(-t_pad // chunk)
    return chunk, -(-n_chunks // walk_kernels.LANES) * walk_kernels.LANES


@pytest.mark.parametrize("block_rays", walk_kernels.BLOCK_SIZES)
def test_smem_plan_fits_every_preset(block_rays):
    """For every PRESETS scene (its whole triangle count: a cutout scene's
    sub-scenes are smaller): the kernels' shared memory stays within the
    budget that lets CTAS_PER_SM CTAs share an SM and under the 227 KB a
    CTA may take, a tile holds whole words, and the tiles cover ranks
    [0, count) once each in order."""
    from optixpathtracer_tpu_torch.scene.procedural import PRESETS
    pk = packet_kernels
    shapes = {_walk_shape(sum(len(m.indices) for m in make()[0].meshes))
              for make in PRESETS.values()}
    assert (256, 1408) in shapes  # hall: 1,322 chunks of 256
    for chunk, maxc_pad in shapes:
        tile, n_bytes = pk.smem_plan(chunk, block_rays, maxc_pad)
        n_sub = chunk // pk.SUB
        assert n_bytes == pk.smem_bytes(tile, chunk, block_rays)
        assert n_bytes <= pk.SMEM_BUDGET < pk.SMEM_MAX == 227 * 1024
        assert pk.CTAS_PER_SM * (n_bytes + 1024) <= pk.SM_SHARED
        assert tile * n_sub % 32 == 0 and 0 < tile
        assert tile >= maxc_pad or pk.smem_bytes(
            tile + 32 // n_sub, chunk, block_rays) > pk.SMEM_BUDGET
        for count in {0, 1, tile - 1, tile, tile + 1, 2 * tile + 3,
                      maxc_pad}:
            if not 0 <= count <= maxc_pad:
                continue
            tiles = pk.union_tiles(count, tile)
            assert [j for j0, j1 in tiles for j in range(j0, j1)] == \
                list(range(count))
            assert all(0 < j1 - j0 <= tile for j0, j1 in tiles)
            assert len(tiles) == -(-count // tile)


def test_smem_plan_budget_and_grid(monkeypatch):
    """A budget of one word's tile gives that tile (the on-card tests set
    it to sweep several tiles); less than that is refused; the grid is one
    CTA of WARPS warps per ray block; and the constants mirror the CUDA
    source's."""
    import os
    import re
    pk = packet_kernels
    assert pk.smem_plan(256, 256, 1408)[0] < 1408  # hall's row: 3 tiles
    for chunk in (128, 256, 384):
        step = 32 // np.gcd(32, chunk // pk.SUB)
        one = pk.smem_bytes(step, chunk, 256)
        monkeypatch.setattr(pk, "SMEM_BUDGET", one)
        assert pk.smem_plan(chunk, 256, 1408) == (step, one)
        assert pk.smem_plan(chunk, 256, 8)[0] == step
        monkeypatch.setattr(pk, "SMEM_BUDGET", one - 16)
        with pytest.raises(ValueError):
            pk.smem_plan(chunk, 256, 1408)
    assert pk.grid(1920 * 1080, 256) == (8100, pk.WARPS * 32)
    assert pk.grid(1000, 1024) == (1, pk.WARPS * 32)
    src = open(os.path.join(os.path.dirname(pk.__file__), os.pardir, "csrc",
                            "packet_intersect.cu")).read()
    for const, value in (("kWarps", pk.WARPS), ("kCtasPerSm", pk.CTAS_PER_SM),
                         ("kRows", pk.ROWS), ("kSub", pk.SUB),
                         ("kPacket", pk.PACKET)):
        assert re.search(rf"constexpr int {const} = (\d+);",
                         src).group(1) == str(value)
