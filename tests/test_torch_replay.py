"""The port's differentiable replay (`optixpathtracer_tpu_torch/diff/
replay.py`) against the JAX package's, on the `conductor` material scene
cut as in tests/test_torch_gradients.py (segments (6, 12)), with the
reference's parameters perturbed by numpy from a seed.

Tolerances:
- init_params, scene_with, raygen_with: rtol 1e-6 (atol 1e-6 where a
  value is near 0): the port rounds its transcendental functions once in
  float64 (`core.math`), the reference's float32 ones are within an ulp
  or three; fitted_geo exactly;
- gradients of an L2 loss w.r.t. every parameter, through "pallas" (the
  dense engine), against `jax.grad` of the reference run op by op: the
  tolerance of tests/test_torch_gradients.py (rtol 1e-4, atol 1e-6 x
  max|g_ref|);
- a replayed scene whose geometry moved hits the moved triangles through
  "pallas" (the brute oracle's hits on the moved scene, exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.diff.replay import MaterialTestReplay as JReplay
from optixpathtracer_tpu.integrate.path import \
    render_sample as jrender_sample
from optixpathtracer_tpu_torch.camera.camera import generate_rays
from optixpathtracer_tpu_torch.diff.replay import (GEO_KEYS,
                                                   MaterialTestReplay,
                                                   replay_params_from_jax)
from optixpathtracer_tpu_torch.integrate.path import render_sample
from optixpathtracer_tpu_torch.intersect import intersect_closest
from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes

torch.set_num_threads(1)

KIND, SEGMENTS, SIZE, BOUNCES = "conductor", (6, 12), 8, 2


@pytest.fixture(scope="module")
def replays():
    return (MaterialTestReplay(KIND, SEGMENTS, device="cpu"),
            JReplay(KIND, SEGMENTS))


@pytest.fixture(scope="module")
def params(replays):
    """The reference's initial parameters, perturbed: (numpy dict)."""
    _, jr = replays
    rng = np.random.default_rng(4)
    out = {}
    for k, v in jr.init_params().items():
        v = np.asarray(v)
        scale = 0.05 if k in ("geo", "cam_pos", "light_dpos") else 0.1
        out[k] = (v + rng.normal(0.0, scale, v.shape)).astype(np.float32)
    return out


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6,
                               err_msg=what)


def test_init_params_match_reference(replays):
    r, jr = replays
    got, want = r.init_params(), jr.init_params()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        close(got[k], want[k], k)
    close(r.jac, jr.jac, "jac")
    np.testing.assert_array_equal(r.tri_idx.numpy(), np.asarray(jr.tri_idx))


def test_scene_with_matches_reference(replays, params):
    r, jr = replays
    got = r.scene_with(replay_params_from_jax(params, device="cpu"))
    want = jr.scene_with({k: jnp.asarray(v) for k, v in params.items()})
    for f in ("tri_v0", "tri_e1", "tri_e2", "mat_albedo", "mat_roughness",
              "light_pos", "light_color"):
        close(getattr(got, f), getattr(want, f), f)
    assert got.cache == {} and got.cache is not r.scene0.cache


def test_raygen_with_matches_reference(replays, params):
    r, jr = replays
    for w, h in ((SIZE, SIZE), (32, 18)):
        got = r.raygen_with(replay_params_from_jax(params, device="cpu"),
                            w, h)
        want = jr.raygen_with({k: jnp.asarray(v) for k, v in params.items()},
                              w, h)
        for name, a, b in zip(("pos", "inv_view", "inv_proj"), got, want):
            close(a, b, name)
    # at the initial parameters it is the camera's own raygen
    init = r.init_params()
    got = r.raygen_with(init, 32, 18)
    for a, b in zip(got, r.camera0.raygen_params(32, 18, device="cpu")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fitted_geo_matches_reference(replays, params):
    r, jr = replays
    assert r.fitted_geo(replay_params_from_jax(params, device="cpu")) == \
        jr.fitted_geo({k: jnp.asarray(v) for k, v in params.items()})


def test_gradients_match_jax(replays, params):
    r, jr = replays
    lobes = scene_active_lobes(r.scene0)
    target = np.random.default_rng(6).uniform(
        0.0, 0.2, (SIZE, SIZE, 3)).astype(np.float32)

    def jloss(p):
        img = jrender_sample(jr.scene_with(p), *jr.raygen_with(p, SIZE, SIZE),
                             SIZE, SIZE, jnp.uint32(0), BOUNCES, "brute",
                             False, lobes, False)
        return jnp.mean((img - target) ** 2)

    with jax.disable_jit():
        want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in
                                params.items()})
    p = {k: v.requires_grad_(True) for k, v in
         replay_params_from_jax(params, device="cpu").items()}
    img = render_sample(r.scene_with(p), *r.raygen_with(p, SIZE, SIZE),
                        SIZE, SIZE, 0, BOUNCES, "pallas", False, lobes,
                        False)
    loss = ((img - torch.from_numpy(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        w = np.asarray(want[k])
        assert np.isfinite(g.numpy()).all(), k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    for k in ("alb_logits", "wall_rough_logit", "geo", "cam_pos", "cam_rot",
              "fov", "light_logi"):
        assert np.abs(np.asarray(want[k])).max() > 0, k


def test_moved_geometry_is_swept_through_pallas(replays):
    """scene_with hands the engines an empty cache: after scene0 has been
    swept through "pallas" (its dense arrays cached on it), a replayed
    scene whose walls and spheres moved is hit where they moved to."""
    r, _ = replays
    cam = r.camera0.raygen_params(32, 32, device="cpu")
    o, d = generate_rays(*cam, 32, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    before = intersect_closest(r.scene0, o, d, method="pallas")
    assert "dense" in r.scene0.cache
    p = r.init_params()
    geo = p["geo"].clone()
    geo[GEO_KEYS.index("radius")] += 0.15
    geo[GEO_KEYS.index("back_x")] -= 0.5
    p["geo"] = geo
    moved = r.scene_with(p)
    with torch.no_grad():
        got = intersect_closest(moved, o, d, method="pallas")
        want = intersect_closest(moved, o, d, method="brute")
    np.testing.assert_array_equal(got.tri_id.numpy(), want.tri_id.numpy())
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    assert (got.tri_id != before.tri_id).float().mean() > 0.05
    assert not torch.equal(moved.cache["dense"][0], r.scene0.cache["dense"][0])
