"""Rank bodies for tests/test_torch_dist.py, run in processes started with
the spawn context. They live in a module of their own that imports no
jax: a child imports only this module and the port (tests/conftest.py,
which sets JAX up, is not run in the children).

`run_ranks` starts one process a rank on gloo (CPU), each with one torch
thread, a process-group timeout and a join deadline, so that a hang fails
the test that started it instead of the whole run."""
import dataclasses
import datetime
import multiprocessing
import os
import socket
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 120


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(body, rank, world_size, port, out_dir, init, kwargs):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if init:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}",
                world_size=world_size, rank=rank,
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        else:  # what torchrun sets; the body joins the group itself
            os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                              WORLD_SIZE=str(world_size),
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        result = body(rank, **kwargs)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(body, world_size, out_dir, timeout_s=240, init=True,
              **kwargs):
    """Run body(rank, **kwargs) on `world_size` gloo ranks; returns each
    rank's dict of arrays. Raises if a rank fails or outlives timeout_s.
    init=False leaves joining the group to the body, with torchrun's
    environment variables set."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, world_size, port, out_dir, init,
                               kwargs))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    errors = []
    for r in range(world_size):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            errors.append(f"rank {r}:\n" + open(err).read())
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"{len(hung)} ranks hung; exit codes "
                           f"{[p.exitcode for p in procs]}\n"
                           + "\n".join(errors))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world_size)]


def frontend_ranks(rank, scenes, size, frame, bounces, target, lr,
                   checkpoint, grad_fields):
    """Each rank: the row-sharded frame of every scene, the material
    gradients and one gradient step, and a sharded render_config
    interrupted at a checkpoint and resumed."""
    from optixpathtracer_tpu_torch.config import RenderConfig
    from optixpathtracer_tpu_torch.dist import (make_mesh,
                                                material_grad_step,
                                                material_grads,
                                                render_sample_sharded)
    from optixpathtracer_tpu_torch.render import render_config
    from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes
    import torch

    mesh = make_mesh()
    assert (mesh.size, mesh.rank) == (4, rank)
    out = {}
    for name, (scene, camera, method) in scenes.items():
        cam = camera.raygen_params(size, size, device="cpu")
        out[f"frame {name}"] = render_sample_sharded(
            mesh, scene, *cam, size, size, frame, bounces, method).numpy()

    scene, camera, method = scenes["cornell"]
    cam = camera.raygen_params(size, size, device="cpu")
    args = (mesh, scene, cam, torch.from_numpy(target), size, size, frame)
    kw = dict(max_bounces=bounces, intersect_method=method,
              active_lobes=scene_active_lobes(scene))
    grads, out["loss"] = material_grads(*args, **kw)
    new, out["step loss"] = material_grad_step(*args, lr=lr, **kw)
    for f in grad_fields:
        out[f"grad {f}"] = grads[f].numpy()
        out[f"step {f}"] = getattr(new, f).numpy()

    cfg = RenderConfig(scene="scene3_cornell", width=size, height=size,
                       spp=2, max_bounces=bounces, sharded=True,
                       checkpoint=checkpoint, checkpoint_every=2,
                       log_every=0)
    render_config(cfg, scene, camera, device="cpu")
    out["resumed"] = render_config(dataclasses.replace(cfg, spp=4), scene,
                                   camera, device="cpu")
    return out


def cli_ranks(rank, argv):
    """Each rank: the CLI with --distributed, as under torchrun."""
    import torch.distributed as dist

    from optixpathtracer_tpu_torch import cli
    rc = cli.main(argv)
    return {"rc": rc, "world": dist.get_world_size(),
            "gloo": dist.get_backend() == "gloo"}
