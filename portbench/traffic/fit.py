"""Material fitting: a closed loop of chained steps of the port's
`dist.material_grad_step` on a mesh of one process (no collective), each
on the scene the last step returned, with the next frame id and the
default learning rate.

Parameters (traffic/<mix>.json): width, height, lr, setup_steps (steps
taken in set-up, through the window's own call; the reference follows the
first three), trace_steps (steps in a traced run), perturb (the half-width
of the uniform perturbation of albedo, roughness and IOR), target_grid
(the side of the random grid the target image is interpolated from).
The perturbation, the target and the first frame id come from the seed.

End-to-end numbers: fit_mrays_s (forward rays, width x height x bounces
x 2 a step, over the window to the last step's completion) and
peak_mem_gib (the allocator's peak over the window). `correct`: the
first three steps' losses, the first gradient as the update applied it
and the parameters' change after three steps, against the reference's
own three steps from the same start.
"""
from __future__ import annotations

import dataclasses

import torch

FIELDS = ("mat_albedo", "mat_metallic", "mat_roughness", "mat_ior")
FIRST_FRAME_SPAN = 1 << 23
CHECKED_STEPS = 3


def inputs(desc, n_mats, traffic, seed, device):
    """(material table {field: tensor}, target [H, W, 3]) from the seed,
    made on the device."""
    import numpy as np
    g = torch.Generator(device=device).manual_seed(seed)
    mats = [m["material"] for m in desc["meshes"]]
    if len(mats) != n_mats:
        raise ValueError(f"{len(mats)} materials described, {n_mats} "
                         f"flattened")
    base = {
        "mat_albedo": np.stack([m["base_color"] for m in mats]),
        "mat_metallic": np.array([m["metallic"] for m in mats]),
        "mat_roughness": np.array([m["roughness"] for m in mats]),
        "mat_ior": np.array([m["ior"] for m in mats])}
    base = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in base.items()}
    half = float(traffic["perturb"])

    def noise(like):
        return (torch.rand(like.shape, generator=g, device=device) * 2.0
                - 1.0) * half
    table = {
        "mat_albedo": torch.clamp(base["mat_albedo"]
                                  + noise(base["mat_albedo"]), 0.0, 1.0),
        "mat_metallic": base["mat_metallic"],
        "mat_roughness": torch.clamp(base["mat_roughness"]
                                     + noise(base["mat_roughness"]), 0.0,
                                     1.0),
        "mat_ior": base["mat_ior"] + noise(base["mat_ior"])}
    k = int(traffic["target_grid"])
    grid = torch.rand((1, 3, k, k), generator=g, device=device) * 0.5
    target = torch.nn.functional.interpolate(
        grid, size=(int(traffic["height"]), int(traffic["width"])),
        mode="bilinear", align_corners=True)[0].permute(1, 2, 0)
    return table, target.contiguous()


class Fit:
    unit = "step"

    def __init__(self, ctx):
        from optixpathtracer_tpu_torch.dist import make_mesh
        from portbench.harness import port
        self.ctx = ctx
        t = ctx.traffic
        self.width, self.height = int(t["width"]), int(t["height"])
        self.bounces = int(ctx.config["bounces"])
        self.lr = float(t["lr"])
        scene, camera = port.scene_and_camera(ctx.desc, ctx.device)
        self.table0, self.target = inputs(
            ctx.desc, scene.mat_albedo.shape[0], t, ctx.seed, ctx.device)
        self.scene = dataclasses.replace(scene, **self.table0)
        self.cam = camera.raygen_params(self.width, self.height, ctx.device)
        self.mesh = make_mesh()
        self.frame_id = int(t["setup_steps"]) + ctx.seed % FIRST_FRAME_SPAN
        self.s0 = self.frame_id
        self.trace_units = int(t["trace_steps"])
        self.losses, self.tables = [], [self.table0]

    def step(self):
        from optixpathtracer_tpu_torch.dist import material_grad_step
        self.scene, loss = material_grad_step(
            self.mesh, self.scene, self.cam, self.target, self.width,
            self.height, self.frame_id, lr=self.lr,
            max_bounces=self.bounces, intersect_method="auto")
        self.frame_id += 1
        return loss

    def warm_up(self):
        """The first steps, through the window's own call; the first three
        are kept for the check."""
        for i in range(int(self.ctx.traffic["setup_steps"])):
            loss = self.step()
            if i < CHECKED_STEPS:
                self.losses.append(loss.detach().clone())
                self.tables.append({f: getattr(self.scene, f).detach()
                                    .clone() for f in FIELDS})

    def window(self, clock, more):
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        clock.start()
        while True:
            self.step()
            clock.unit_done()
            if not more(clock.units):
                break
        seconds, _ = clock.finish()
        rays = self.width * self.height * self.bounces * 2 * clock.units
        out = {"fit_mrays_s": rays / seconds / 1e6}
        if dev.type == "cuda":
            out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out

    def check(self):
        got_losses = [float(x) for x in self.losses]
        self.scene = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        want = self.reference("float32")
        _report_nonfinite("program", self.tables)
        _report_nonfinite("reference", want[1])
        return compare(got_losses, self.tables, *want, self.lr)

    def reference(self, precision, rows=None):
        """The reference's own checked steps from the same start: (losses,
        material tables from the start on, first step's gradients). `rows`:
        see `shade.fit_step`."""
        from portbench.reference import scene as ref_scene
        from portbench.reference import shade
        dev = self.ctx.device
        q = shade.Precision(precision)
        rs = ref_scene.flatten(self.ctx.desc, dev).replace(
            **self.table0)
        cam = ref_scene.camera_params(self.ctx.desc["camera"], self.width,
                                      self.height, dev)
        block = int(self.ctx.workload["rows_per_block"])
        losses, tables, first_grads = [], [self.table0], None
        for k in range(CHECKED_STEPS):
            new, loss, grads = shade.fit_step(
                rs, cam, self.target, self.s0 + k, self.bounces, self.lr,
                block, q, rows)
            if first_grads is None:
                first_grads = grads
            losses.append(float(loss))
            tables.append(new)
            rs = rs.replace(**new)
        return losses, tables, first_grads


def _report_nonfinite(side, tables):
    """One line on standard error for each table entry that is not
    finite: the step after which it is, the field and the material."""
    import sys
    for k, table in enumerate(tables):
        for f in FIELDS:
            bad = torch.nonzero(~torch.isfinite(table[f]))
            if bad.numel():
                print(f"fit: {side} table after step {k}: {f} not finite at "
                      f"{bad[:8, 0].tolist()} ({bad.shape[0]} entries)",
                      file=sys.stderr)


def leaf_gap(got, want, leaves):
    """The worst leaf's gap between the norms of got[f] and want[f], over
    the larger of want[f]'s norm and the median leaf's."""
    norms = {f: float(torch.linalg.vector_norm(want[f])) for f in leaves}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(torch.linalg.vector_norm(got[f])) - norms[f])
               / max(norms[f], med, 1e-30) for f in leaves)


def compare(got_losses, got_tables, want_losses, want_tables, ref_grads,
            lr):
    """loss_gap: the largest relative gap of the checked steps' losses;
    grad_gap: leaf_gap of the first update over lr (the gradient as the
    update applied it); step_gap: leaf_gap of the change after the checked
    steps. Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out (they move by round-off alone)."""
    norms = {f: float(torch.linalg.vector_norm(g))
             for f, g in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    leaves = [f for f in FIELDS if norms[f] >= 1e-3 * med]
    n = len(want_losses)
    if len(got_losses) < n or len(got_tables) < n + 1:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "step_gap": float("inf")}

    def per(tables, a, b, scale=1.0):
        return {f: (tables[a][f] - tables[b][f]) / scale for f in leaves}
    bad = [f for f in leaves for t in got_tables[:n + 1]
           if not bool(torch.isfinite(t[f]).all())]
    return {
        "loss_gap": max(abs(g - w) / max(abs(w), 1e-30)
                        for g, w in zip(got_losses, want_losses)),
        "grad_gap": float("inf") if bad else leaf_gap(
            per(got_tables, 0, 1, lr), per(want_tables, 0, 1, lr), leaves),
        "step_gap": float("inf") if bad else leaf_gap(
            per(got_tables, n, 0), per(want_tables, n, 0), leaves)}


def make(ctx):
    return Fit(ctx)
