"""The port's multi-device layer (`optixpathtracer_tpu_torch/dist`) on four
gloo ranks on the CPU (tests/torch_dist_worker.py, spawned processes that
import no jax), against the single process and against the JAX package.

Tolerances:
- row-sharded frames, and the sharded render_config interrupted at a
  checkpoint and resumed: bit for bit the single process's. Every ray's
  answer is independent of its batch, so no tolerance is allowed;
- render_rows against the reference's op-by-op render_rows: the criterion
  of tests/test_torch_render.py;
- the four ranks' material gradients and loss against one process's:
  rtol 1e-6, atol 1e-6 x max|g| (the ranks' partial sums add up in
  another order); the SGD step within lr x that plus one ulp;
- the gradients against `jax.grad` of the reference's loss, and the step
  against the reference's `material_grad_step`, both op by op: the
  tolerance of tests/test_torch_gradients.py (rtol 1e-4, atol 1e-6 x
  max|g_ref|), carried through the step as lr x that plus one ulp.
  The reference's step is not run on its 8-device mesh: that program
  took 94 s to compile (16x16, 1 bounce) and 170 s op by op on an 8-core
  CPU, over this file's budget, so its row-sharded render is replaced by
  its single-device `render_sample`, which tests/test_dist.py holds the
  sharded program to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from optixpathtracer_tpu.dist import render_rows as jrender_rows
from optixpathtracer_tpu.dist import sharding as jsharding
from optixpathtracer_tpu.integrate.path import \
    render_sample as jrender_sample
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu_torch.config import RenderConfig
from optixpathtracer_tpu_torch.dist import (Mesh, initialize_distributed,
                                            make_mesh, material_grad_step,
                                            material_grads, render_rows,
                                            render_sample_sharded)
from optixpathtracer_tpu_torch.dist.sharding import GRAD_FIELDS
from optixpathtracer_tpu_torch.film import read_exr
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.render import load_checkpoint, render_config
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes
from optixpathtracer_tpu_torch.scene.procedural import (PRESETS,
                                                        scene_material_test)

torch.set_num_threads(1)

SIZE, FRAME, BOUNCES, LR, RANKS = 16, 3, 2, 0.05, 4


@pytest.fixture(scope="module")
def scenes():
    """{name: (scene, camera, method)}: Cornell through "auto" (the brute
    oracle on the CPU), and the `diffuse` material scene (cut as in
    tests/test_torch_gradients.py) through the walk and packet engines,
    whose plain versions sort and block the rays they are given."""
    model, camera, lights = PRESETS["scene3_cornell"]()
    cornell = flatten_model(model, lights, device="cpu")
    model, mcamera, lights = scene_material_test("diffuse",
                                                 segments=(6, 12))
    diffuse = flatten_model(model, lights, device="cpu")
    return {"cornell": (cornell, camera, "auto"),
            "diffuse walk": (diffuse, mcamera, "walk"),
            "diffuse packet": (diffuse, mcamera, "packet")}


@pytest.fixture(scope="module")
def target():
    rng = np.random.default_rng(5)
    return rng.uniform(0.0, 0.1, (SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(scenes, target, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return torch_dist_worker.run_ranks(
        torch_dist_worker.frontend_ranks, RANKS, str(out), scenes=scenes,
        size=SIZE, frame=FRAME, bounces=BOUNCES, target=target, lr=LR,
        checkpoint=str(out / "ck.npz"), grad_fields=GRAD_FIELDS)


@pytest.fixture(scope="module")
def cornell(scenes):
    scene, camera, method = scenes["cornell"]
    return (scene, camera.raygen_params(SIZE, SIZE, device="cpu"), method,
            scene_active_lobes(scene))


@pytest.fixture(scope="module")
def one_process(cornell, target):
    scene, cam, method, lobes = cornell
    args = (make_mesh(), scene, cam, torch.from_numpy(target), SIZE, SIZE,
            FRAME)
    kw = dict(max_bounces=BOUNCES, intersect_method=method,
              active_lobes=lobes)
    grads, loss = material_grads(*args, **kw)
    new, step_loss = material_grad_step(*args, lr=LR, **kw)
    assert torch.equal(loss, step_loss)
    return ({f: g.numpy() for f, g in grads.items()}, float(loss),
            {f: getattr(new, f).numpy() for f in GRAD_FIELDS})


@pytest.fixture(scope="module")
def reference(target):
    """(jax.grad of the reference's loss, its loss, and the reference's
    material_grad_step's new fields), op by op on one device, with the
    scene's own lobes (as tests/test_torch_gradients.py runs it)."""
    model, camera, lights = JPRESETS["scene3_cornell"]()
    jscene = jflatten(model, lights)
    cam = camera.raygen_params(SIZE, SIZE)
    lobes = (0,)  # Cornell is all diffuse

    def single(mesh, scene, pos, iv, ip, w, h, frame, bounces, method,
               active_lobes=None):
        return jrender_sample(scene, pos, iv, ip, w, h, frame, bounces,
                              method, active_lobes=active_lobes,
                              use_textures=False)

    def loss_fn(params):
        img = single(None, jscene._replace(**params), *cam, SIZE, SIZE,
                     jnp.uint32(FRAME), BOUNCES, "brute", lobes)
        return jnp.mean((img - target) ** 2)

    params = {f: getattr(jscene, f) for f in GRAD_FIELDS}
    saved = jsharding.render_sample_sharded
    jsharding.render_sample_sharded = single
    try:
        with jax.disable_jit():
            loss, grads = jax.value_and_grad(loss_fn)(params)
            new, step_loss = jsharding.material_grad_step(
                None, jscene, cam, jnp.asarray(target), SIZE, SIZE,
                jnp.uint32(FRAME), lr=LR, max_bounces=BOUNCES,
                intersect_method="brute", active_lobes=lobes)
    finally:
        jsharding.render_sample_sharded = saved
    assert float(step_loss) == float(loss)
    return ({f: np.asarray(g) for f, g in grads.items()}, float(loss),
            {f: np.asarray(getattr(new, f)) for f in GRAD_FIELDS},
            {f: np.asarray(p) for f, p in params.items()})


def assert_grads_close(got, want, rtol):
    for f in GRAD_FIELDS:
        g, w = got[f], want[f]
        assert g.shape == w.shape and np.isfinite(g).all(), f
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=1e-6 * np.abs(w).max(), err_msg=f)
    assert np.abs(want["mat_albedo"]).max() > 0


def assert_steps_close(got, want, grads, params, rtol):
    """new = clip(p - lr g): the gradients' tolerance times lr, plus an
    ulp of the parameter for the rounding of the update."""
    for f in GRAD_FIELDS:
        g = np.abs(grads[f])
        atol = LR * (rtol * g + 1e-6 * g.max()) + np.spacing(
            np.abs(params[f]).astype(np.float32))
        assert np.all(np.abs(got[f] - want[f]) <= atol), f


@pytest.mark.parametrize("name", ["cornell", "diffuse walk",
                                  "diffuse packet"])
def test_sharded_frame_equals_single_process(scenes, ranks, name):
    scene, camera, method = scenes[name]
    want = path.render_sample(
        scene, *camera.raygen_params(SIZE, SIZE, device="cpu"), SIZE, SIZE,
        FRAME, BOUNCES, method,
        active_lobes=scene_active_lobes(scene)).numpy()
    assert want.mean() > 0
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"frame {name}"], want,
                                      err_msg=f"rank {r}")


def test_lost_shard_recovery(cornell):
    """Any row block, recomputed from its coordinates alone, equals the
    full frame's rows bit for bit."""
    scene, cam, method, lobes = cornell
    full = path.render_sample(scene, *cam, SIZE, SIZE, 5, BOUNCES, method,
                              active_lobes=lobes).numpy()
    for y0, rows in ((6, 2), (0, 5), (13, 3)):
        tile = render_rows(scene, *cam, SIZE, SIZE, 5, y0, rows, BOUNCES,
                           method).numpy()
        np.testing.assert_array_equal(tile, full[y0:y0 + rows])


def test_render_rows_matches_reference(cornell):
    scene, cam, _, _ = cornell
    model, camera, lights = JPRESETS["scene3_cornell"]()
    jscene = jflatten(model, lights)
    y0, rows = 6, 4
    with jax.disable_jit():
        want = np.asarray(jrender_rows(
            jscene, *camera.raygen_params(SIZE, SIZE), SIZE, SIZE,
            jnp.uint32(5), jnp.uint32(y0), rows, max_bounces=BOUNCES,
            intersect_method="brute"))
    got = render_rows(scene, *cam, SIZE, SIZE, 5, y0, rows, BOUNCES,
                      "brute").numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


def test_grads_equal_one_process(ranks, one_process):
    grads, loss, _ = one_process
    for r, out in enumerate(ranks):
        got = {f: out[f"grad {f}"] for f in GRAD_FIELDS}
        assert_grads_close(got, grads, rtol=1e-6)
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-6)
        np.testing.assert_array_equal(out["step loss"], out["loss"])
        for f in GRAD_FIELDS:  # every rank holds the same sum
            np.testing.assert_array_equal(out[f"grad {f}"],
                                          ranks[0][f"grad {f}"])


def test_step_equals_one_process(cornell, ranks, one_process):
    grads, _, new = one_process
    params = {f: getattr(cornell[0], f).numpy() for f in GRAD_FIELDS}
    for out in ranks:
        got = {f: out[f"step {f}"] for f in GRAD_FIELDS}
        assert_steps_close(got, new, grads, params, rtol=1e-6)
    assert not np.array_equal(new["mat_albedo"], params["mat_albedo"])


def test_grads_match_reference(ranks, reference):
    grads, loss, _, _ = reference
    got = {f: ranks[0][f"grad {f}"] for f in GRAD_FIELDS}
    assert_grads_close(got, grads, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-5)


def test_step_matches_reference(ranks, reference):
    grads, _, new, params = reference
    got = {f: ranks[0][f"step {f}"] for f in GRAD_FIELDS}
    assert_steps_close(got, new, grads, params, rtol=1e-4)


def test_sharded_render_config_resumes_bit_for_bit(scenes, ranks,
                                                   tmp_path_factory):
    """Four ranks, each accumulating its own rows, stopped at a
    checkpoint and resumed from it, give the single process's image."""
    scene, camera, _ = scenes["cornell"]
    cfg = RenderConfig(scene="scene3_cornell", width=SIZE, height=SIZE,
                       spp=4, max_bounces=BOUNCES, log_every=0)
    want = render_config(cfg, scene, camera, device="cpu")
    for out in ranks:
        np.testing.assert_array_equal(out["resumed"], want)


def test_single_process_mesh_and_fallbacks(cornell, monkeypatch, capsys):
    """One process: a mesh of one with no group; heights that do not
    divide raise; without torchrun's environment initialize_distributed
    is a no-op; render_config's sharded flag prints the reference's
    fallback line and renders single-device."""
    scene, cam, method, _ = cornell
    mesh = make_mesh()
    assert (mesh.group, mesh.size, mesh.rank, mesh.axis) == (None, 1, 0,
                                                             "tiles")
    with pytest.raises(ValueError):
        make_mesh(2)
    with pytest.raises(ValueError):
        render_sample_sharded(Mesh(None, 3, 0), scene, *cam, SIZE, SIZE, 0)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    cfg = RenderConfig(scene="scene3_cornell", width=SIZE, height=SIZE,
                       spp=1, max_bounces=1, log_every=0)
    _, pcamera, _ = PRESETS["scene3_cornell"]()
    single = render_config(cfg, scene, pcamera, device="cpu")
    sharded = render_config(dataclasses.replace(cfg, sharded=True), scene,
                            pcamera, device="cpu")
    assert "sharded: falling back to single-device (1 devices, height 16)" \
        in capsys.readouterr().out
    np.testing.assert_array_equal(sharded, single)


def test_checkpoint_holds_the_resumed_count(ranks, tmp_path_factory):
    """The resumed sharded render wrote the final checkpoint (rank 0)."""
    ck = [p for p in tmp_path_factory.getbasetemp().glob("ranks*/ck.npz")]
    assert ck, "no checkpoint written"
    accum, next_frame = load_checkpoint(str(ck[0]), device="cpu")
    assert next_frame == 4
    np.testing.assert_array_equal(accum.numpy(), ranks[0]["resumed"])


def test_cli_distributed_sharded(scenes, tmp_path):
    """`--distributed --sharded` on four ranks with torchrun's environment
    (gloo with --device cpu): the ranks join one group, rank 0 writes the
    files, and the image is the single process's bit for bit."""
    exr, ckpt = str(tmp_path / "d.exr"), str(tmp_path / "d.npz")
    argv = ["--scene", "scene3_cornell", "--device", "cpu", "--width",
            str(SIZE), "--height", str(SIZE), "--spp", "2",
            "--max-bounces", str(BOUNCES), "--distributed", "--sharded",
            "--out-exr", exr, "--checkpoint", ckpt]
    out = torch_dist_worker.run_ranks(torch_dist_worker.cli_ranks, RANKS,
                                      str(tmp_path), init=False, argv=argv)
    assert [(int(o["rc"]), int(o["world"]), bool(o["gloo"])) for o in out] \
        == [(0, RANKS, True)] * RANKS
    scene, camera, _ = scenes["cornell"]
    want = render_config(RenderConfig(scene="scene3_cornell", width=SIZE,
                                      height=SIZE, spp=2,
                                      max_bounces=BOUNCES, log_every=0),
                         scene, camera, device="cpu")
    np.testing.assert_array_equal(read_exr(exr), want)
    accum, n = load_checkpoint(ckpt, device="cpu")
    assert n == 2
    np.testing.assert_array_equal(accum.numpy(), want)
