"""Multi-device rendering: pixel rows sharded over the ranks of a process
group (port of `optixpathtracer_tpu/dist/sharding.py`).

The reference is single-controller: one process drives every chip through
`shard_map`. The port uses PyTorch's idiom: one process per GPU (launched
by `torchrun`), NCCL between GPUs and gloo between CPU processes.

* forward: rank r renders the contiguous row block [r h, (r + 1) h)
  (`render_rows`), and `all_gather_into_tensor` assembles the frame;
* backward: each rank differentiates its rows' share of the loss, and the
  gradients and the loss are all-reduced with SUM (the psum that
  `shard_map`'s transpose inserts in the reference);
* every ray's answer is independent of the rays beside it (order-free
  closest hit, ties to the lowest id; `core.math` rounds the same on every
  device), so a sharded frame equals the single-process frame bit for bit.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.math import div
from ..integrate.path import render_sample

GRAD_FIELDS = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that pixel rows are sharded over: the process group (None
    for a single process that was never initialised, which runs no
    collective), its size, this process's rank in it and the axis name.

    A small dataclass rather than a `DeviceMesh`: rows shard along one axis
    only, and a DeviceMesh is built for a device type, which the gloo
    (CPU) and NCCL (GPU) runs of the same code would have to pass along;
    the collectives here need nothing but the group."""
    group: object
    size: int
    rank: int
    axis: str = "tiles"


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    """The mesh over every rank of the default group (one process: a mesh
    of one). n_devices, if given, must be that number of ranks."""
    if dist.is_initialized():
        group, size, rank = (dist.group.WORLD, dist.get_world_size(),
                             dist.get_rank())
    else:
        group, size, rank = None, 1, 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"{n_devices} devices asked for, {size} ranks run")
    return Mesh(group, size, rank, axis)


def initialize_distributed(device="cuda") -> bool:
    """Join the process group of a `torchrun` launch: NCCL on "cuda"
    (after setting this rank's GPU from LOCAL_RANK), gloo on "cpu".

    It initialises only where torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR) says this is one of several processes; a single process
    is a no-op, as in the reference. Returns True if more than one rank
    runs."""
    from ..scene.flatten import _device
    env = os.environ
    if not all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    device = _device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(env.get(
                "LOCAL_RANK", int(env["RANK"]) % torch.cuda.device_count())))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size() > 1


def render_rows(scene, cam_position, cam_inv_view, cam_inv_proj,
                width: int, height: int, frame_id, y0, h_local: int,
                max_bounces: int = 2, intersect_method: str = "auto",
                active_lobes=None, reference_compat: bool = False,
                use_textures: bool = True, use_alpha_cutout: bool = False,
                flat_shading: bool = False):
    """Render pixel rows [y0, y0 + h_local) of the full height x width
    frame: [h_local, width, 3], a pure function of (scene, camera,
    frame_id, y0) (`render_sample`'s row window). It is the per-rank body
    of `render_sample_sharded` and the lost-shard recovery primitive: any
    row block is recomputable from its coordinates alone. It follows
    autograd as `render_sample` does."""
    if active_lobes is None:
        from ..scene.flatten import scene_active_lobes
        active_lobes = scene_active_lobes(scene)
    return render_sample(scene, cam_position, cam_inv_view, cam_inv_proj,
                         width, height, frame_id, max_bounces,
                         intersect_method, reference_compat, active_lobes,
                         use_textures, use_alpha_cutout,
                         flat_shading=flat_shading, y0=y0, h_local=h_local)


def gather_rows(mesh: Mesh, rows):
    """Every rank's row block, in rank order, on every rank (the block
    itself where no group runs)."""
    if mesh.group is None:
        return rows
    rows = rows.detach().contiguous()
    out = rows.new_empty((mesh.size * rows.shape[0],) + rows.shape[1:])
    dist.all_gather_into_tensor(out, rows, group=mesh.group)
    return out


def _rows_of(mesh: Mesh, height: int):
    if height % mesh.size:
        raise ValueError(f"height {height} not divisible by {mesh.size} "
                         f"devices")
    h_local = height // mesh.size
    return mesh.rank * h_local, h_local


def render_sample_sharded(mesh: Mesh, scene, cam_position, cam_inv_view,
                          cam_inv_proj, width: int, height: int, frame_id,
                          max_bounces: int = 2,
                          intersect_method: str = "auto",
                          active_lobes=None,
                          reference_compat: bool = False,
                          use_textures: bool = True,
                          use_alpha_cutout: bool = False,
                          flat_shading: bool = False):
    """One 1-spp frame with its rows sharded over the mesh: each rank
    renders its block, then the blocks are gathered. Returns the full
    [H, W, 3] frame on every rank (forward only: `material_grad_step`
    is the gradient path). height must divide by the mesh size."""
    y0, h_local = _rows_of(mesh, height)
    rows = render_rows(scene, cam_position, cam_inv_view, cam_inv_proj,
                       width, height, frame_id, y0, h_local, max_bounces,
                       intersect_method, active_lobes, reference_compat,
                       use_textures, use_alpha_cutout, flat_shading)
    return gather_rows(mesh, rows)


def material_grads(mesh: Mesh, scene, cam_params, target, width: int,
                   height: int, frame_id, max_bounces: int = 2,
                   intersect_method: str = "auto", active_lobes=None):
    """({field: gradient}, loss) of the L2 loss (the mean over the whole
    image) of a row-sharded frame against `target` [H, W, 3], w.r.t. the
    material table (GRAD_FIELDS). Each rank differentiates the sum over
    its rows divided by H x W x 3; the gradients and the loss are then
    all-reduced with SUM (one collective), so every rank holds the
    same. Intersection is detached in every engine (intersect/api.py), so
    the kernels are safe here."""
    pos, inv_view, inv_proj = cam_params
    y0, h_local = _rows_of(mesh, height)
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in GRAD_FIELDS}
    rows = render_rows(dataclasses.replace(scene, **params), pos, inv_view,
                       inv_proj, width, height, frame_id, y0, h_local,
                       max_bounces, intersect_method, active_lobes)
    err = rows - target[y0:y0 + h_local]
    loss = div((err * err).sum(), float(height * width * 3))
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    loss = loss.detach()
    if mesh.group is not None:
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        loss = flat[0]
        grads = [piece.view_as(g) for piece, g in
                 zip(torch.split(flat[1:], [g.numel() for g in grads]),
                     grads)]
    return dict(zip(GRAD_FIELDS, grads)), loss


def material_grad_step(mesh: Mesh, scene, cam_params, target,
                       width: int, height: int, frame_id,
                       lr: float = 0.05, max_bounces: int = 2,
                       intersect_method: str = "auto",
                       active_lobes=None):
    """One inverse-rendering step: `material_grads`, then the SGD update
    with the reference's clamps, the same on every rank.

    Returns (new_scene, loss)."""
    grads, loss = material_grads(mesh, scene, cam_params, target, width,
                                 height, frame_id, max_bounces,
                                 intersect_method, active_lobes)
    new = {f: getattr(scene, f).detach() - lr * g for f, g in grads.items()}
    for f in ("mat_albedo", "mat_roughness", "mat_metallic"):
        new[f] = torch.clamp(new[f], 0.0, 1.0)
    return dataclasses.replace(scene, **new), loss
