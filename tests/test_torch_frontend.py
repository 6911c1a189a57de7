"""The port's front end (`config.py`, `render.py`, `cli.py`) against the
JAX package's.

Tolerances:
- configs: every `scenes/config*.json` loads to the reference's field dict,
  exactly;
- render_config interrupted at a checkpoint and resumed: bit for bit the
  uninterrupted render (the frames' seeds and the running mean do not
  depend on the chunking);
- a checkpoint written by the reference's render_config (run op by op,
  `jax.disable_jit()`) resumes in the port's, and the port's in the
  reference's: the engine-golden criterion of tests/test_torch_render.py
  (> 99.5% of pixels within atol 1e-5 / rtol 1e-4, mean within 1e-3);
- the CLI's files: the EXR holds the returned image bit for bit, the PNG
  and BMP decode to `to_display` of it.
"""
import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from optixpathtracer_tpu import cli as jcli
from optixpathtracer_tpu.config import RenderConfig as JRenderConfig
from optixpathtracer_tpu.render import render_config as jrender_config
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu_torch import cli
from optixpathtracer_tpu_torch.config import RenderConfig
from optixpathtracer_tpu_torch.film import read_exr, to_display
from optixpathtracer_tpu_torch.integrate.path import render_chunk
from optixpathtracer_tpu_torch.render import (load_checkpoint, load_scene,
                                              render_config,
                                              save_checkpoint)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "scenes", "config*.json")))


def images_match(img, want):
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


@pytest.fixture(scope="module")
def cornell():
    return load_scene(RenderConfig(scene="scene3_cornell"), device="cpu")


def _cfg(**kw):
    base = dict(scene="scene3_cornell", width=16, height=16, spp=4,
                max_bounces=2, log_every=0)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_configs_load_as_reference(path, tmp_path):
    cfg = RenderConfig.from_json(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JRenderConfig.from_json(path))
    out = str(tmp_path / "c.json")
    cfg.to_json(out)
    assert RenderConfig.from_json(out) == cfg


def test_config_fields_and_unknown_keys(tmp_path):
    assert dataclasses.asdict(RenderConfig()) == dataclasses.asdict(
        JRenderConfig())
    p = str(tmp_path / "bad.json")
    json.dump({"scene": "diffuse", "device": "cpu"}, open(p, "w"))
    with pytest.raises(ValueError, match="unknown config keys"):
        RenderConfig.from_json(p)


def test_resume_bit_identical(cornell, tmp_path, capsys):
    scene, camera = cornell
    ckpt = str(tmp_path / "r.npz")
    full = render_config(_cfg(), scene, camera, device="cpu")
    render_config(_cfg(spp=2, checkpoint=ckpt, checkpoint_every=2), scene,
                  camera, device="cpu")
    assert load_checkpoint(ckpt, device="cpu")[1] == 2
    resumed = render_config(_cfg(checkpoint=ckpt, checkpoint_every=2,
                                 log_every=10), scene, camera, device="cpu")
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at sample 2" in out
    assert "at Sample: 4/4" in out
    np.testing.assert_array_equal(resumed, full)
    accum, next_frame = load_checkpoint(ckpt, device="cpu")
    assert next_frame == 4
    np.testing.assert_array_equal(accum.numpy(), full)


def test_chunking_bit_identical(cornell):
    scene, camera = cornell
    one = render_config(_cfg(frames_per_launch=1), scene, camera,
                        device="cpu")
    many = render_config(_cfg(frames_per_launch=3), scene, camera,
                         device="cpu")
    np.testing.assert_array_equal(one, many)


def test_checkpoints_cross_packages(cornell, tmp_path):
    """A checkpoint written by the reference resumes in the port, and the
    port's in the reference; both match the uninterrupted renders."""
    scene, camera = cornell
    jmodel, jcamera, jlights = JPRESETS["scene3_cornell"]()
    jscene = jflatten(jmodel, jlights)
    kw = dict(scene="scene3_cornell", width=16, height=16, max_bounces=2,
              intersect="brute", log_every=0, checkpoint_every=2)
    theirs, ours = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    with jax.disable_jit():
        jrender_config(JRenderConfig(spp=2, checkpoint=theirs, **kw),
                       jscene, jcamera)
        want = jrender_config(JRenderConfig(spp=4, **kw), jscene, jcamera)
    got = render_config(RenderConfig(spp=4, checkpoint=theirs, **kw),
                        scene, camera, device="cpu")
    images_match(got, want)
    render_config(RenderConfig(spp=2, checkpoint=ours, **kw), scene, camera,
                  device="cpu")
    with jax.disable_jit():
        back = jrender_config(JRenderConfig(spp=4, checkpoint=ours, **kw),
                              jscene, jcamera)
    images_match(np.asarray(back), want)


def test_checkpoint_round_trip(tmp_path):
    accum = torch.from_numpy(
        np.random.default_rng(1).random((4, 5, 3)).astype(np.float32))
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, accum, 7)
    back, n = load_checkpoint(p, device="cpu")
    assert n == 7 and back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), accum.numpy())
    assert not os.path.exists(p + ".tmp.npz")


def test_resume_rejects_a_checkpoint_of_another_size(cornell, tmp_path):
    """A checkpoint of another frame size raises before any rendering,
    naming both sizes, and is left as it was."""
    scene, camera = cornell
    ckpt = str(tmp_path / "small.npz")
    save_checkpoint(ckpt, torch.zeros((8, 8, 3)), 2)
    with pytest.raises(ValueError, match="8x8x3 accumulator; this render "
                                         "is 16x16x3"):
        render_config(_cfg(checkpoint=ckpt), scene, camera, device="cpu")
    accum, next_frame = load_checkpoint(ckpt, device="cpu")
    assert accum.shape == (8, 8, 3) and next_frame == 2


@pytest.mark.parametrize("y0, rows", [(0, 16), (0, 5), (11, 5)])
def test_render_chunk_row_window(cornell, y0, rows):
    """render_chunk over a row window (what each rank of a sharded
    render_config accumulates) equals those rows of the full frame's
    accumulation bit for bit."""
    scene, camera = cornell
    params = camera.raygen_params(16, 16, device="cpu")
    full = render_chunk(scene, *params, 16, 16,
                        torch.zeros((16, 16, 3)), 1, 2, 2,
                        active_lobes=(0,))
    got = render_chunk(scene, *params, 16, 16,
                       torch.zeros((rows, 16, 3)), 1, 2, 2,
                       active_lobes=(0,), y0=y0)
    np.testing.assert_array_equal(got.numpy(), full[y0:y0 + rows].numpy())


def test_cli_writes_all_three_files(tmp_path, capsys):
    """The flagship config through the CLI, cut by flags (which override
    the file): one rank, so `sharded` falls back with the reference's
    line."""
    exr, png, bmp = (str(tmp_path / f"full.{e}") for e in ("exr", "png",
                                                          "bmp"))
    ckpt = str(tmp_path / "full.ckpt")
    assert cli.main(["--config", os.path.join(ROOT, "scenes",
                                              "config5_full.json"),
                     "--device", "cpu", "--width", "16", "--height", "16",
                     "--spp", "2", "--out-exr", exr, "--out-png", png,
                     "--out-bmp", bmp, "--checkpoint", ckpt]) == 0
    out = capsys.readouterr().out
    assert "sharded: falling back to single-device (1 devices, height 16)" \
        in out
    assert "at Sample: 2/2" in out and "done: 16x16x2spp" in out
    img = read_exr(exr)
    accum, n = load_checkpoint(ckpt, device="cpu")
    assert n == 2 and img.shape == (16, 16, 3) and img.mean() > 0
    np.testing.assert_array_equal(img, accum.numpy())
    np.testing.assert_array_equal(
        np.asarray(Image.open(png).convert("RGB"))[::-1], to_display(img))
    np.testing.assert_array_equal(np.asarray(Image.open(bmp))[::-1],
                                  to_display(img))


def test_cli_profile_and_engines(tmp_path):
    prof = str(tmp_path / "prof")
    assert cli.main(["--scene", "scene3_cornell", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--intersect", "packet", "--profile", prof]) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    parser = cli.build_parser()
    choices = next(a.choices for a in parser._actions
                   if a.dest == "intersect")
    jchoices = next(a.choices for a in jcli.build_parser()._actions
                    if a.dest == "intersect")
    assert set(choices) == set(jchoices) | {"packet"}


def test_cli_list_scenes_as_reference(capsys):
    assert cli.main(["--list-scenes"]) == 0
    ours = capsys.readouterr().out
    jcli.main(["--list-scenes"])
    assert ours == capsys.readouterr().out
    assert "scene3_cornell" in ours.split()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behaviour without a GPU")
def test_cli_without_gpu_raises(tmp_path):
    """It never falls back to the CPU: without --device cpu and without a
    GPU it raises before rendering, and so does render_config."""
    out = str(tmp_path / "x.exr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "scene3_cornell", "--width", "8", "--height",
                  "8", "--spp", "1", "--out-exr", out])
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_config(_cfg(spp=1))
