"""High-level rendering API: config -> scene -> progressive render -> files
(port of `optixpathtracer_tpu/render.py`).

The orchestration layer replacing the reference's OptixView/main
(`OptixView.cpp:130-185` run loop, `main.cpp`), with checkpoint/resume of
the accumulator, a progress heartbeat and row-sharded rendering over the
ranks of a process group (`dist/`). The checkpoint is the reference's
`.npz` (`accum`, `next_frame`), so a render started by either package
resumes in the other.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed

from .camera import Camera
from .config import RenderConfig
from .dist import gather_rows, make_mesh
from .film import write_bmp, write_exr, write_png
from .integrate.cutout import scene_uses_alpha_cutout
from .integrate.path import render_chunk
from .scene import flatten_model
from .scene.flatten import (_device, scene_active_lobes, scene_flat_shading,
                            scene_uses_textures)
from .scene.gltf import load_gltf
from .scene.procedural import PRESETS
from .scene.types import PointLight


def load_scene(cfg: RenderConfig, device="cuda"):
    """Resolve cfg.scene to (SceneData on `device`, Camera)."""
    if cfg.scene in PRESETS:
        model, camera, lights = PRESETS[cfg.scene]()
    elif os.path.exists(cfg.scene):
        model = load_gltf(cfg.scene, reference_compat=cfg.reference_compat)
        camera = Camera.from_blender((3.85382, 0.0, 1.0), (90.0, 0.0, 90.0))
        lights = [PointLight(np.array([0.0, 1.69221, 0.0], np.float32),
                             np.ones(3, np.float32))]
    else:
        raise ValueError(f"unknown scene {cfg.scene!r} "
                         f"(presets: {sorted(PRESETS)})")
    return flatten_model(model, lights, device=device), camera


def save_checkpoint(path, accum, next_frame):
    """Accumulator + sample counter: the complete resumable render state
    (the RNG is a function of pixel and frame, so nothing else is needed)."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, accum=accum.detach().cpu().numpy()
                 if isinstance(accum, torch.Tensor) else np.asarray(accum),
                 next_frame=next_frame)
    os.replace(tmp, path)


def load_checkpoint(path, device="cuda"):
    """(accum as a float32 tensor on `device`, next_frame)."""
    data = np.load(path)
    return (torch.as_tensor(np.asarray(data["accum"], np.float32),
                            device=_device(device)),
            int(data["next_frame"]))


def render_config(cfg: RenderConfig, scene=None, camera=None, device="cuda"):
    """Run a full progressive render per the config on `device` (the GPU
    unless the caller asks for the CPU; a given scene must lie there).
    Returns the final linear [H, W, 3] numpy image.

    With cfg.sharded and more than one rank whose count divides the height,
    each rank accumulates only its own rows; the accumulator is gathered
    only to write a checkpoint or the output, and only rank 0 writes files
    and logs."""
    device = _device(device)
    if scene is None or camera is None:
        scene, camera = load_scene(cfg, device)
    elif scene.device.type != device.type:
        raise ValueError(f"the scene lies on {scene.device}, not {device}")
    device = scene.device

    flags = {"active_lobes": scene_active_lobes(scene),
             "use_textures": scene_uses_textures(scene),
             "use_alpha_cutout": scene_uses_alpha_cutout(scene),
             "flat_shading": scene_flat_shading(scene)}
    pos, inv_view, inv_proj = camera.raygen_params(cfg.width, cfg.height,
                                                   device)

    ranks = make_mesh()
    lead = ranks.rank == 0  # only rank 0 logs and writes files
    mesh, y0, h_local = None, 0, cfg.height
    if cfg.sharded:
        # pixel rows sharded over the ranks (torchrun, one GPU a rank)
        if ranks.size > 1 and cfg.height % ranks.size == 0:
            mesh = ranks
            h_local = cfg.height // mesh.size
            y0 = mesh.rank * h_local
        elif lead:
            print(f"sharded: falling back to single-device "
                  f"({ranks.size} devices, height {cfg.height})")

    def gathered(acc):
        return acc if mesh is None else gather_rows(mesh, acc)

    accum = torch.zeros((h_local, cfg.width, 3), device=device)
    start = 0
    if cfg.checkpoint and os.path.exists(cfg.checkpoint):
        full, start = load_checkpoint(cfg.checkpoint, device)
        if full.shape != (cfg.height, cfg.width, 3):
            raise ValueError(
                f"checkpoint {cfg.checkpoint} holds a "
                f"{'x'.join(map(str, full.shape))} accumulator; this render "
                f"is {cfg.height}x{cfg.width}x3 (give another --checkpoint "
                f"or remove it)")
        accum = full[y0:y0 + h_local].contiguous()
        if lead:
            print(f"resumed from {cfg.checkpoint} at sample {start}")

    # Chunks of frames_per_launch frames; chunks stop at checkpoint
    # boundaries, and every frame has the same seed and running-mean
    # update whatever the chunking, so a resumed image is bit-identical
    # to an uninterrupted one.
    per_launch = max(1, cfg.frames_per_launch)
    t0 = time.time()
    s = start
    while s < cfg.spp:
        chunk = min(per_launch, cfg.spp - s)
        if cfg.checkpoint:  # stop at the next checkpoint boundary
            to_ckpt = cfg.checkpoint_every - s % cfg.checkpoint_every
            chunk = min(chunk, to_ckpt)
        accum = render_chunk(scene, pos, inv_view, inv_proj, cfg.width,
                             cfg.height, accum, s, chunk, cfg.max_bounces,
                             cfg.intersect, cfg.reference_compat, **flags,
                             y0=y0)
        s += chunk
        if lead and cfg.log_every and (s % cfg.log_every < chunk
                                       or s == cfg.spp):
            # reference heartbeat "at Sample: N" (`OptixView.cpp:159-161`)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rate = (s - start) / max(time.time() - t0, 1e-9)
            print(f"at Sample: {s}/{cfg.spp} ({rate:.2f} spp/s)",
                  flush=True)
        if cfg.checkpoint and s % cfg.checkpoint_every == 0 and s < cfg.spp:
            full = gathered(accum)
            if lead:
                save_checkpoint(cfg.checkpoint, full, s)

    img = gathered(accum).cpu().numpy()
    if lead:
        if cfg.checkpoint:
            save_checkpoint(cfg.checkpoint, img, cfg.spp)
        if cfg.out_exr:
            write_exr(cfg.out_exr, img)  # linear, like the reference's EXR
        if cfg.out_png:
            write_png(cfg.out_png, img, cfg.tonemap)
        if cfg.out_bmp:
            write_bmp(cfg.out_bmp, img, cfg.tonemap)
    if ranks.group is not None:  # the files exist once any rank returns
        torch.distributed.barrier(group=ranks.group)
    return img
