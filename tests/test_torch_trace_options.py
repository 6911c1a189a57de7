"""The `trace_paths` options of the port against the JAX package's: the
coherence permutations lane for lane, `sort_rays` frames, the dispatch
over subsets of the lobes, `render_chunk` with options and the
`debug_pixel` lines.

The reference runs op by op (`jax.disable_jit()`, see
tests/test_torch_render.py). Sorting the wavefront changes no lane's
arithmetic and no closest hit, so sorted frames must equal the port's own
unsorted frame bit for bit."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from optixpathtracer_tpu.bsdf import dispatch as jdispatch
from optixpathtracer_tpu.integrate import path as jpath
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu_torch.bsdf import dispatch
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.procedural import PRESETS

from test_torch_lobes import _mats, _t
from test_torch_render import assert_images_match

torch.set_num_threads(1)

SIZE = 16
DIFFUSE_ONLY = dict(active_lobes=(dispatch.DIFFUSE,), use_textures=False)


def _frame(scene, params, bounces, **kw):
    return path.render_sample(scene, *params, SIZE, SIZE, 0, bounces,
                              "brute", **kw).numpy()


def _jframe(jscene, jparams, bounces, **kw):
    with jax.disable_jit():
        return np.asarray(jpath.render_sample(
            jscene, *jparams, SIZE, SIZE, jnp.uint32(0), bounces, "brute",
            **kw))


@pytest.fixture(scope="module")
def cornell():
    model, camera, lights = PRESETS["scene3_cornell"]()
    jmodel, jcamera, jlights = JPRESETS["scene3_cornell"]()
    return (flatten_model(model, lights, device="cpu"),
            camera.raygen_params(SIZE, SIZE, device="cpu"),
            jflatten(jmodel, jlights), jcamera.raygen_params(SIZE, SIZE))


# ---------------------------------------------------------------------------
# Permutations
# ---------------------------------------------------------------------------

def _rays(n=4096, seed=0):
    """Origins in and around Cornell's box (some exactly at its middle),
    directions with exact zeros and negative zeros, a third of the lanes
    dead."""
    r = np.random.default_rng(seed)
    o = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:64] = 0.0
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[r.uniform(size=(n, 3)) < 0.1] = 0.0
    d[r.uniform(size=(n, 3)) < 0.05] = -0.0
    alive = r.uniform(size=n) > 0.33
    return o, d, alive


@pytest.mark.parametrize("bounds", ["bvh", "triangles"])
def test_coherence_permutations_identical(cornell, bounds):
    """_bucket_permutation, the Morton key and its stable argsort, lane for
    lane, with the scene bounds from the BVH root and, for a scene without
    BVH nodes, from the triangles."""
    scene, _, jscene, _ = cornell
    if bounds == "triangles":
        scene = dataclasses.replace(scene, bvh_min=scene.bvh_min[:0],
                                    bvh_max=scene.bvh_max[:0])
        jscene = jscene._replace(bvh_min=jscene.bvh_min[:0],
                                 bvh_max=jscene.bvh_max[:0])
    np.testing.assert_array_equal(
        torch.stack(path._scene_bounds(scene)).numpy(),
        np.stack(jpath._scene_bounds(jscene)))
    o, d, alive = _rays()
    t = [torch.from_numpy(x) for x in (o, d, alive)]
    with jax.disable_jit():
        jperm = np.asarray(jpath._bucket_permutation(jscene, o, d, alive))
        jkey = np.asarray(jpath._coherence_sort_key(jscene, o, d, alive))
        jmorton = np.asarray(jnp.argsort(jkey))
    np.testing.assert_array_equal(path._bucket_permutation(scene, *t).numpy(),
                                  jperm)
    key = path._coherence_sort_key(scene, *t)
    np.testing.assert_array_equal(key.numpy(), jkey.astype(np.int64))
    assert (key[~t[2]] == path.DEAD_KEY).all()
    np.testing.assert_array_equal(
        torch.argsort(key, stable=True).numpy(), jmorton)
    # the buckets and the Morton cells really are spread over
    assert len(np.unique(jkey)) > 100
    assert len(np.unique(jperm[:64])) == 64


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 70).flatmap(lambda k: st.tuples(
    st.just(k), st.lists(st.integers(0, k - 1), min_size=1, max_size=300))))
def test_perm_from_key_is_the_counting_sort(case):
    """The stable argsort equals the reference's one-hot counting sort."""
    k, keys = case
    want = np.asarray(jpath._perm_from_key(jnp.asarray(keys, jnp.int32), k))
    got = path._perm_from_key(torch.tensor(keys), k).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option,value,bounces", [
    ("sort_rays", True, 2), ("sort_rays", "morton", 2)])
def test_sort_options_match_reference_and_unsorted(cornell, option, value,
                                                   bounces):
    scene, params, jscene, jparams = cornell
    kw = {option: value, **DIFFUSE_ONLY}
    img = _frame(scene, params, bounces, **kw)
    np.testing.assert_array_equal(img, _frame(scene, params, bounces,
                                              **DIFFUSE_ONLY))
    assert img.mean() > 0.01
    assert_images_match(img, _jframe(jscene, jparams, bounces, **kw))


# ---------------------------------------------------------------------------
# Subsets of the lobes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(5)
    n = 512

    def unit():
        v = r.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    return dict(albedo=r.uniform(0, 1, (n, 3)).astype(np.float32),
                rough=r.uniform(0.05, 1, n).astype(np.float32),
                ior=r.uniform(1.2, 2.0, n).astype(np.float32),
                mat_type=r.integers(0, 4, n).astype(np.int32),
                seed=r.integers(0, 2**32, n, dtype=np.uint64).astype(
                    np.uint32), wo=unit(), wi=unit())


@pytest.mark.parametrize("off", [(), (dispatch.GLOSSY_DIFFUSE,),
                                 (dispatch.DIFFUSE, dispatch.DIELECTRIC),
                                 dispatch.ALL_LOBES])
def test_gates_match_reference(lanes, off):
    """f and sample with the lobes of `off` left out of `active_lobes`,
    against the reference's dispatch with the same `active_lobes`: a lane
    of an absent lobe gets zeros (an invalid sample), an absent lobe draws
    nothing, and in f only the layered lobe hands its seed on. Every lobe
    is the default, bit for bit."""
    x = lanes
    lobes = tuple(lobe for lobe in dispatch.ALL_LOBES if lobe not in off)
    n = len(x["rough"])
    tm, jm = _mats(x, dispatch, _t, n), _mats(x, jdispatch, jnp.asarray, n)
    seed = _t(x["seed"])
    tseed_f, tf = dispatch.f(seed, tm, _t(x["wo"]), _t(x["wi"]), lobes)
    tseed_s, ts = dispatch.sample(seed, tm, _t(x["wo"]), lobes)
    with jax.disable_jit():
        jseed_f, jf = jdispatch.f(jnp.asarray(x["seed"]), jm, x["wo"],
                                  x["wi"], active_lobes=lobes)
        jseed_s, js = jdispatch.sample(jnp.asarray(x["seed"]), jm, x["wo"],
                                       active_lobes=lobes)
    np.testing.assert_array_equal(tseed_f.numpy().astype(np.uint32),
                                  np.asarray(jseed_f))
    np.testing.assert_array_equal(tseed_s.numpy().astype(np.uint32),
                                  np.asarray(jseed_s))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)
    for k in js._fields:
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    absent = np.isin(x["mat_type"], off)
    assert not tf[absent].any() and not ts.valid[absent].any()
    if not off:
        default_f = dispatch.f(seed, tm, _t(x["wo"]), _t(x["wi"]))
        default_s = dispatch.sample(seed, tm, _t(x["wo"]))
        assert torch.equal(default_f[0], tseed_f)
        assert torch.equal(default_f[1], tf)
        assert torch.equal(default_s[0], tseed_s)
        assert all(torch.equal(a, b) for a, b in zip(default_s[1], ts))
    if off == dispatch.ALL_LOBES:
        assert torch.equal(tseed_f, seed) and torch.equal(tseed_s, seed)


# ---------------------------------------------------------------------------
# render_chunk and debug_pixel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"sort_rays": True},
                                {"sort_rays": "morton"},
                                {"flat_shading": True}])
def test_render_chunk_with_options_chains_render_sample(cornell, kw):
    scene, params, _, _ = cornell
    accum = torch.zeros((SIZE, SIZE, 3))
    got = path.render_chunk(scene, *params, SIZE, SIZE, accum, 3, 2,
                            max_bounces=2, **DIFFUSE_ONLY, **kw)
    want = accum
    for s in (3, 4):
        frame = path.render_sample(scene, *params, SIZE, SIZE, s, 2,
                                   **DIFFUSE_ONLY, **kw)
        want = want + (frame - want) / (torch.tensor(float(s)) + 1.0)
    assert torch.equal(got, want)
    assert want.mean() > 0.01


NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _debug_lines(text):
    lines = [ln for ln in text.splitlines()
             if ln.startswith("debug ray bounce")]
    return ([[float(v) for v in NUMBER.findall(ln)] for ln in lines],
            [re.findall(r"alive=\[?(True|False)", ln) for ln in lines])


def test_debug_pixel_prints_the_reference_fields(cornell, capfd):
    scene, params, jscene, jparams = cornell
    lane = 7 * SIZE + 9
    capfd.readouterr()
    img = _frame(scene, params, 2, debug_pixel=lane, **DIFFUSE_ONLY)
    ours = capfd.readouterr().out
    _jframe(jscene, jparams, 2, debug_pixel=lane, **DIFFUSE_ONLY)
    theirs = capfd.readouterr().out
    got, got_alive = _debug_lines(ours)
    want, want_alive = _debug_lines(theirs)
    assert len(got) == len(want) == 2
    assert got_alive == want_alive
    for g, w in zip(got, want):
        assert len(g) == len(w) == 15  # bounce, 4 vectors, 2 scalars
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    # nothing is sorted under debug_pixel, and the frame is the plain one
    np.testing.assert_array_equal(img, _frame(scene, params, 2,
                                              **DIFFUSE_ONLY))
