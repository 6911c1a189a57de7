"""Port parity of textures, alpha cutout and the opaque/cutout scene split
against the JAX package: texture sampling and decode, textured
`make_surface`, the cutout queries on the textured quad of
tests/test_cutout.py, `flatten_model` and `scene_from_jax` on `hall_small`
(sub-scenes and `tri_outer_id` included), and a whole `scene_hall(0.1)`
frame through the port's `render` against the reference's op-by-op
`render(..., intersect_method="brute")`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.integrate import cutout as jcutout
from optixpathtracer_tpu.integrate import render as jrender
from optixpathtracer_tpu.integrate.surface import \
    make_surface as jmake_surface
from optixpathtracer_tpu.intersect import intersect_closest as jclosest
from optixpathtracer_tpu.scene import Material as JMaterial
from optixpathtracer_tpu.scene import Model as JModel
from optixpathtracer_tpu.scene import PointLight as JPointLight
from optixpathtracer_tpu.scene import Texture as JTexture
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene import textures as jtextures
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu.scene.procedural import quad as jquad
from optixpathtracer_tpu_torch.integrate import cutout, path
from optixpathtracer_tpu_torch.integrate.surface import make_surface
from optixpathtracer_tpu_torch.intersect import intersect_any
from optixpathtracer_tpu_torch.intersect.types import Hit
from optixpathtracer_tpu_torch.scene import (Material, Model, PointLight,
                                             Texture, flatten_model,
                                             scene_from_jax, textures)
from optixpathtracer_tpu_torch.scene.flatten import SceneData
from optixpathtracer_tpu_torch.scene.procedural import PRESETS, quad

from cutout_stack import LANES, TIE_LANE, stack_model, stack_rays
from test_torch_render import assert_images_match

torch.set_num_threads(1)


def jax_leaves(jscene):
    """A JAX SceneData's leaves as numpy arrays, sub-scenes as nested
    dicts (the form `scene_from_jax` takes)."""
    return {k: None if v is None
            else jax_leaves(v) if hasattr(v, "_asdict") else np.asarray(v)
            for k, v in jscene._asdict().items()}


def assert_leaves_equal(scene, want):
    for f in dataclasses.fields(SceneData):
        k = f.name
        if k == "cache":
            continue
        got = getattr(scene, k)
        if want[k] is None:
            assert got is None, k
        elif isinstance(want[k], dict):
            assert_leaves_equal(got, want[k])
        else:
            g = got.numpy()
            assert g.dtype == want[k].dtype, (k, g.dtype, want[k].dtype)
            np.testing.assert_array_equal(g, want[k], err_msg=k)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------

def test_srgb_to_linear_matches_reference():
    """Equal to the reference's decode within rtol 5e-7 (about 4 float32
    ulp): its `** 2.4` is XLA's float32 pow, which on the CPU is within 3
    ulp of the true value (37% of these samples correctly rounded,
    measured). The port's is evaluated in float64 and rounded once, so it
    is the correctly rounded value, which is checked exactly."""
    c = np.random.default_rng(0).uniform(0.0, 1.0, 4096).astype(np.float32)
    c[:4] = (0.0, 0.04045, 0.0405, 1.0)
    got = textures.srgb_to_linear(_t(c)).numpy()
    want = np.asarray(jtextures.srgb_to_linear(jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    base = (c.astype(np.float32) + np.float32(0.055)) / np.float32(1.055)
    exact = np.where(c <= 0.04045, c / np.float32(12.92),
                     (base.astype(np.float64) ** 2.4).astype(np.float32))
    np.testing.assert_array_equal(got, exact)


def test_sample_bilinear_matches_reference():
    """Wrap addressing with uv outside [0, 1) (negative included), texel
    ids out of range clamped: bit-identical to the reference."""
    rng = np.random.default_rng(1)
    tex = rng.uniform(0.0, 1.0, (3, 16, 16, 4)).astype(np.float32)
    u = rng.uniform(-2.5, 3.5, 2000).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, 2000).astype(np.float32)
    u[:3] = (-1e-9, 0.0, 1.0)
    tid = rng.integers(-1, 5, 2000).astype(np.int32)
    got = textures.sample_bilinear(_t(tex), _t(tid), _t(u), _t(v)).numpy()
    want = np.asarray(jtextures.sample_bilinear(
        jnp.asarray(tex), jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


def _textured_models():
    """Three quads with albedo, metal-rough and normal textures (uv tiled
    past 1), in both packages, and rays at them."""
    rng = np.random.default_rng(2)
    pix = [rng.uniform(0.0, 1.0, (32, 32, 4)).astype(np.float32)
           for _ in range(3)]
    models = []
    for mat_cls, quad_fn, tex_cls, model_cls in (
            (JMaterial, jquad, JTexture, JModel),
            (Material, quad, Texture, Model)):
        full = mat_cls(base_color=np.array([0.9, 0.8, 0.7], np.float32),
                       metallic=0.6, roughness=0.5, mat_type="metallic_mix",
                       albedo_texture=0, metal_rough_texture=1,
                       normal_texture=2)
        mr_only = mat_cls(mat_type="glossy_diffuse", metal_rough_texture=1,
                          normal_texture=2)
        meshes = [quad_fn((0.0, 0.0, -1.0), (0.0, 0.0, 2.0), (0.0, 2.0, 0.0),
                          full, "wall"),
                  quad_fn((-3.0, 0.0, -3.0), (0.0, 0.0, 6.0), (6.0, 0.0, 0.0),
                          mr_only, "floor"),
                  quad_fn((-3.0, 3.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0),
                          mat_cls(mat_type="diffuse"), "ceiling")]
        for m in meshes:
            m.uvs = m.uvs * 3.0 - 1.0
        models.append(model_cls(meshes=meshes,
                                textures=[tex_cls(pixels=p) for p in pix]))
    o = rng.uniform((1.0, 0.2, -0.8), (2.5, 2.8, 0.8), (1024, 3))
    d = rng.normal(size=(1024, 3))
    d[:, 0] = -np.abs(d[:, 0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return models, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("reference_compat", [False, True])
def test_textured_make_surface_matches_reference(reference_compat):
    """Textured shading (albedo x decoded texel, the metal/rough channels,
    the normal map) equal to the reference's on the same hits and seeds.
    Tolerance rtol 1e-5 / atol 1e-6: the reference runs its jnp ops one by
    one, the port the same operations, and they may part by an ulp where
    the reference's float32 pow or sqrt rounds differently."""
    (jmodel, model), o, d = _textured_models()
    jscene = jflatten(jmodel)
    scene = flatten_model(model, device="cpu")
    jhit = jclosest(jscene, o, d, 0.0, 100.0, method="brute")
    assert np.asarray(jhit.hit).mean() > 0.5
    seed = np.random.default_rng(3).integers(0, 2**32, 1024,
                                             dtype=np.uint32)
    with jax.disable_jit():
        _, jsurf = jmake_surface(jnp.asarray(seed), jscene, o, d, jhit,
                                 reference_compat=reference_compat)
    hit = Hit(*[_t(np.array(x)) for x in jhit])
    _, surf = make_surface(_t(seed.astype(np.int64)), scene, _t(o), _t(d),
                           hit, reference_compat=reference_compat)
    m = np.asarray(jhit.hit)
    for k in ("position", "g_normal", "s_normal", "tangent", "bitangent",
              "wo_local", "uv"):
        np.testing.assert_allclose(getattr(surf, k).numpy()[m],
                                   np.asarray(getattr(jsurf, k))[m],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("albedo", "metallic", "roughness", "ior"):
        np.testing.assert_allclose(getattr(surf.mat, k).numpy()[m],
                                   np.asarray(getattr(jsurf.mat, k))[m],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(surf.mat.mat_type.numpy()[m],
                                  np.asarray(jsurf.mat.mat_type)[m])


# ---------------------------------------------------------------------------
# Alpha cutout on the quad scene of tests/test_cutout.py
# ---------------------------------------------------------------------------

def _cutout_models():
    """A vertical quad at x=0 whose texture alpha is 0 in the band v in
    [0.25, 0.75), plus an opaque floor, in both packages."""
    tex = np.ones((64, 64, 4), np.float32)
    tex[16:48, :, 3] = 0.0
    out = []
    for mat_cls, quad_fn, tex_cls, model_cls, light_cls in (
            (JMaterial, jquad, JTexture, JModel, JPointLight),
            (Material, quad, Texture, Model, PointLight)):
        wall = quad_fn((0.0, 0.0, -1.0), (0.0, 0.0, 2.0), (0.0, 1.0, 0.0),
                       mat_cls(mat_type="diffuse", albedo_texture=0), "wall")
        floor = quad_fn((-5.0, -0.5, -5.0), (0.0, 0.0, 10.0),
                        (10.0, 0.0, 0.0), mat_cls(mat_type="diffuse"),
                        "floor")
        out.append((model_cls(meshes=[wall, floor],
                              textures=[tex_cls(pixels=tex)]),
                    [light_cls(np.array([3.0, 0.5, 0.0]), np.ones(3))]))
    return out


@pytest.fixture(scope="module")
def cutout_scenes():
    (jmodel, jlights), (model, lights) = _cutout_models()
    return jflatten(jmodel, jlights), flatten_model(model, lights,
                                                    device="cpu")


def _legacy(scene):
    return dataclasses.replace(scene, opaque_scene=None, cutout_sub=None,
                               cache={})


RAYS_O = np.array([[2.0, 0.5, 0.0], [2.0, 0.1, 0.0], [2.0, 0.9, 0.3],
                   [2.0, 0.5, 0.4]], np.float32)
RAYS_D = np.array([[-1.0, 0.0, 0.0]] * 4, np.float32)


def test_scene_detects_cutout_and_splits(cutout_scenes):
    jscene, scene = cutout_scenes
    assert cutout.scene_uses_alpha_cutout(scene)
    assert jcutout.scene_uses_alpha_cutout(jscene)
    assert scene.opaque_scene is not None and scene.cutout_sub is not None
    assert_leaves_equal(scene, jax_leaves(jscene))


@pytest.mark.parametrize("split", [True, False])
def test_radiance_rays_pass_through_the_hole(cutout_scenes, split):
    """The ray through the hole hits nothing, the others the wall at
    t = 2; equal to the reference (split and legacy paths)."""
    jscene, scene = cutout_scenes
    if not split:
        jscene, scene = jscene._replace(opaque_scene=None,
                                        cutout_sub=None), _legacy(scene)
    got = cutout.intersect_closest_cutout(scene, _t(RAYS_O), _t(RAYS_D), 0.0,
                                          100.0, method="brute")
    want = jcutout.intersect_closest_cutout(jscene, RAYS_O, RAYS_D, 0.0,
                                            100.0, method="brute")
    np.testing.assert_array_equal(got.hit.numpy(), [False, True, True, False])
    for k in ("hit", "tri_id", "back_face"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6)
    np.testing.assert_allclose(got.t.numpy()[1], 2.0, atol=1e-4)


@pytest.mark.parametrize("split", [True, False])
def test_shadow_rays_honour_cutout(cutout_scenes, split):
    """From behind the wall toward the light: through the hole the light
    is visible, through the opaque band it is not; the plain occlusion
    query, which knows no cutout, blocks both."""
    jscene, scene = cutout_scenes
    if not split:
        jscene, scene = jscene._replace(opaque_scene=None,
                                        cutout_sub=None), _legacy(scene)
    o = np.array([[-1.0, 0.5, 0.0], [-1.0, 0.1, 0.0]], np.float32)
    to_l = np.array([3.0, 0.0, 0.0], np.float32) - o
    dist = np.linalg.norm(to_l, axis=-1).astype(np.float32)
    d = (to_l / dist[:, None]).astype(np.float32)
    got = cutout.intersect_any_cutout(scene, _t(o), _t(d), 0.0, _t(dist),
                                      method="brute").numpy()
    np.testing.assert_array_equal(got, [False, True])
    np.testing.assert_array_equal(
        got, np.asarray(jcutout.intersect_any_cutout(jscene, o, d, 0.0, dist,
                                                     method="brute")))
    assert intersect_any(scene, _t(o), _t(d), 0.0, _t(dist),
                         method="brute").all()


def test_split_path_matches_legacy(cutout_scenes):
    """The opaque/cutout split reproduces the full-scene chain exactly."""
    _, scene = cutout_scenes
    legacy = _legacy(scene)
    o, d = _t(RAYS_O), _t(RAYS_D)
    hs = cutout.intersect_closest_cutout(scene, o, d, 0.0, 100.0,
                                         method="brute")
    hl = cutout.intersect_closest_cutout(legacy, o, d, 0.0, 100.0,
                                         method="brute")
    for a, b in zip(hs, hl):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        cutout.intersect_any_cutout(scene, o, d, 0.0, 100.0,
                                    method="brute").numpy(),
        cutout.intersect_any_cutout(legacy, o, d, 0.0, 100.0,
                                    method="brute").numpy())


# ---------------------------------------------------------------------------
# The hall
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hall_small():
    """The reference's hall_small scene and its leaves, and the port's
    model, camera and lights."""
    jmodel, _, jlights = JPRESETS["hall_small"]()
    model, camera, lights = PRESETS["hall_small"]()
    jscene = jflatten(jmodel, jlights)
    return jax_leaves(jscene), (model, camera, lights), jscene


def test_flatten_hall_small_matches_reference(hall_small):
    """Every leaf of the outer scene and of both sub-scenes, tri_outer_id
    included, equal to the reference's flatten."""
    want, (model, _, lights), _ = hall_small
    scene = flatten_model(model, lights, device="cpu")
    assert int(scene.tri_valid.sum()) == 20606
    assert int(scene.cutout_sub.tri_valid.sum()) == 40
    assert_leaves_equal(scene, want)
    # sub-scene ids map back onto the same outer triangles
    for sub in (scene.opaque_scene, scene.cutout_sub):
        ok = sub.tri_valid
        outer = sub.tri_outer_id[ok].long()
        assert (outer >= 0).all()
        np.testing.assert_array_equal(sub.tri_v0[ok].numpy(),
                                      scene.tri_v0[outer].numpy())


def test_scene_from_jax_carries_subscenes(hall_small):
    want, _, _ = hall_small
    scene = scene_from_jax(want, device="cpu")
    assert_leaves_equal(scene, want)
    scene.cache["x"] = scene.opaque_scene.cache["x"] = 1
    moved = scene.to("cpu")
    assert moved.cache == {} and moved.opaque_scene.cache == {}
    assert moved.opaque_scene is not scene.opaque_scene
    assert_leaves_equal(moved, want)


@pytest.fixture(scope="module")
def hall_frames():
    """scene_hall(0.1) (10,334 triangles, 81 walk chunks, cutout live):
    the port's scene and camera, and the reference's op-by-op 16x16
    frame."""
    from optixpathtracer_tpu.scene.procedural import scene_hall as jhall
    from optixpathtracer_tpu_torch.scene.procedural import scene_hall
    jmodel, jcamera, jlights = jhall(0.1)
    with jax.disable_jit():
        want = np.asarray(jrender(jflatten(jmodel, jlights), jcamera, 16, 16,
                                  spp=1, max_bounces=2,
                                  intersect_method="brute"))
    model, camera, lights = scene_hall(0.1)
    return flatten_model(model, lights, device="cpu"), camera, want


@pytest.mark.parametrize("method", ["packet", "walk", "brute"])
def test_hall_frame_matches_reference(hall_frames, method):
    """A textured, cutout, five-lobe frame through the port's `render`
    (textures and cutout on by the scene's defaults; "packet" and "walk"
    run their plain versions here) against the reference's, by the
    engine-golden criterion."""
    scene, camera, want = hall_frames
    assert cutout.scene_uses_alpha_cutout(scene)
    assert scene.opaque_scene.walk_tris.shape[0] == 81
    img = path.render(scene, camera, 16, 16, spp=1, max_bounces=2,
                      intersect_method=method).numpy()
    assert img.mean() > 0.05
    assert_images_match(img, want)


def test_hall_small_frame_matches_reference_op_by_op(hall_small):
    """hall_small's rotated camera at 12x12, 1 spp, 2 bounces, brute,
    against the reference run op by op, by the engine-golden criterion:
    the camera rays are bit-identical, so only the sRGB decode's float32
    pow (within 3 ulp) parts the two frames."""
    with jax.disable_jit():
        jmodel, jcamera, jlights = JPRESETS["hall_small"]()
        want = np.asarray(jrender(jflatten(jmodel, jlights), jcamera, 12, 12,
                                  spp=1, max_bounces=2,
                                  intersect_method="brute"))
    _, (model, camera, lights), _ = hall_small
    scene = flatten_model(model, lights, device="cpu")
    img = path.render(scene, camera, 12, 12, spp=1, max_bounces=2,
                      intersect_method="brute").numpy()
    assert img.mean() > 0.05
    assert_images_match(img, want)


# ---------------------------------------------------------------------------
# The cutout chains: routing, the plain chain, its count of re-traced layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_type,split,engine,n_chunks,want", [
    ("cuda", True, "pallas", 1, True),     # the hall's 40-triangle leaves
    ("cuda", True, "pallas", 7, True),     # the largest tile a CTA stages
    ("cuda", True, "pallas", 8, False),    # WALK_MIN_CHUNKS: too large
    ("cpu", True, "pallas", 1, False),     # CPU tensors: the plain chain
    ("cuda", False, "pallas", 1, False),   # the unsplit full-scene chain
    ("cuda", True, "walk", 1, False),      # explicit engines keep it too
    ("cuda", True, "packet", 1, False),
    ("cuda", True, "brute", 1, False),
    ("cuda", True, "bvh", 1, False),
])
def test_chain_kernel_route(device_type, split, engine, n_chunks, want):
    """The chain kernels serve exactly the CUDA chains over a split scene's
    cutout sub-scene that the dense engine serves and one tile holds."""
    assert cutout.chain_kernel_route(device_type, split, engine,
                                     n_chunks) is want


@pytest.fixture(scope="module")
def stack():
    model, lights = stack_model()
    return flatten_model(model, lights, device="cpu")


def _stack_lanes():
    return [lane for lane, *_ in LANES.values()]


def test_chain_kernel_refuses_cpu_tensors(stack):
    """On the CPU the chains are plain; the kernel wrappers raise rather
    than run elsewhere than on CUDA."""
    o, d, tmin, tmax = stack_rays(_stack_lanes(), "cpu")
    assert not cutout._uses_chain_kernel(stack.cutout_sub, o, "auto")
    with pytest.raises(ValueError, match="CUDA"):
        cutout.closest_chain_kernel(stack.cutout_sub, o, d, tmin, tmax)
    with pytest.raises(ValueError, match="CUDA"):
        cutout.any_chain_kernel(stack.cutout_sub, o, d, tmin, tmax,
                                torch.ones_like(tmin, dtype=torch.bool))


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_plain_chains_on_stacked_quads(stack, method):
    """Six aligned holes: the radiance chain stops at its fifth hole (the
    exhaustion rule), the shadow chain occludes beyond its layers; the
    queries over the split scene add the opaque wall behind the stack."""
    assert stack.opaque_scene is not None and stack.cutout_sub is not None
    sub = stack.cutout_sub
    o, d, tmin, tmax = stack_rays(_stack_lanes(), "cpu")
    best_t, best_id = cutout.closest_chain_plain(sub, o, d, tmin, tmax,
                                                 method)
    blocked = cutout.any_chain_plain(sub, o, d, tmin, tmax,
                                     torch.ones_like(tmin, dtype=torch.bool),
                                     method)
    want_t = [t for _, t, _, _ in LANES.values()]
    for name, got, want in zip(LANES, best_t.tolist(), want_t):
        assert got == (float("inf") if want is None else
                       pytest.approx(want, abs=1e-5)), name
    assert ((best_id >= 0) == torch.isfinite(best_t)).all()
    assert blocked.tolist() == [b for _, _, b, _ in LANES.values()]
    # the whole queries: the wall at t = 10 stops what the chain lets by
    hit = cutout.intersect_closest_cutout(stack, o, d, tmin, tmax,
                                          method=method)
    wall = (tmin < 10.0) & (tmax > 10.0)
    for name, t, h, w, (lane, want, _, _) in zip(
            LANES, hit.t.tolist(), hit.hit.tolist(), wall.tolist(),
            LANES.values()):
        want = want if want is not None else 10.0 if w else None
        assert h == (want is not None), name
        if h:
            assert t == pytest.approx(want, abs=1e-5), name
    any_hit = cutout.intersect_any_cutout(stack, o, d, tmin, tmax,
                                          method=method)
    assert any_hit.tolist() == [b or w for b, w in
                                zip(blocked.tolist(), wall.tolist())]


def test_chain_reentries_hand_count(stack):
    """The plain count of re-traced layers (what the kernels add to
    `last_reentries`) equals the hand count, lane by lane and in all, for
    both chains; a lane the gate leaves out re-traces nothing."""
    sub = stack.cutout_sub
    for lane, (_, _, _, want) in zip(_stack_lanes(), LANES.values()):
        rays = stack_rays([lane], "cpu")
        gate = torch.ones(1, dtype=torch.bool)
        assert cutout.chain_reentries("closest", sub, *rays) == want, lane
        assert cutout.chain_reentries("any", sub, *rays, gate) == want, lane
        assert cutout.chain_reentries("any", sub, *rays, ~gate) == 0, lane
    rays = stack_rays(_stack_lanes() + [TIE_LANE], "cpu")
    total = sum(n for *_, n in LANES.values())
    assert cutout.chain_reentries("closest", sub, *rays[:4]) in (
        total, total + 1)  # the tie lane re-enters once if the hole wins


def test_plain_chain_on_hall_small_matches_reference(hall_small):
    """hall_small's cutout queries on rays aimed at its leaves (many pass
    a hole, some several), from origins before and inside the foliage:
    hits, ids and blocked flags equal to the reference's, t, u and v
    within rtol 1e-6 (both refine the same ids the same way)."""
    _, (model, _, lights), jscene = hall_small
    scene = flatten_model(model, lights, device="cpu")
    sub = scene.cutout_sub
    rng = np.random.default_rng(4)
    ok = sub.tri_valid.numpy()
    v0, e1, e2 = (getattr(sub, k).numpy()[ok]
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    n = 384
    k = rng.integers(0, len(v0), n)
    a = rng.uniform(0.0, 1.0, (n, 2))
    a = np.where(a.sum(axis=1, keepdims=True) > 1.0, 1.0 - a, a)
    target = v0[k] + a[:, :1] * e1[k] + a[:, 1:] * e2[k]
    o = (target + rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = rng.choice([0.0, 0.0, 0.5], n).astype(np.float32)
    tmax = rng.choice([100.0, 3.0], n).astype(np.float32)
    got = cutout.intersect_closest_cutout(scene, _t(o), _t(d), _t(tmin),
                                          _t(tmax), method="brute")
    blocked = cutout.intersect_any_cutout(scene, _t(o), _t(d), _t(tmin),
                                          _t(tmax), method="brute")
    layers = torch.zeros(n, dtype=torch.int64)
    cutout.closest_chain_plain(sub, _t(o), _t(d), _t(tmin), _t(tmax),
                               "brute", layers)
    assert (layers > 1).sum() > n // 10 and layers.max() > 2
    with jax.disable_jit():
        want = jcutout.intersect_closest_cutout(jscene, o, d, tmin, tmax,
                                                method="brute")
        want_blocked = jcutout.intersect_any_cutout(jscene, o, d, tmin, tmax,
                                                    method="brute")
    assert got.hit.any() and blocked.any() and not blocked.all()
    for k_ in ("hit", "tri_id", "back_face"):
        np.testing.assert_array_equal(getattr(got, k_).numpy(),
                                      np.asarray(getattr(want, k_)),
                                      err_msg=k_)
    for k_ in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k_).numpy(),
                                   np.asarray(getattr(want, k_)), rtol=1e-6,
                                   atol=1e-7, err_msg=k_)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(want_blocked))
