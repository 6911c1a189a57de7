"""Progressive rendering: a closed loop of 1-spp frames at a fixed
resolution through the port's `integrate.path.render_chunk`, one frame a
call, accumulated into the running mean as `render` accumulates it.

Parameters (traffic/<mix>.json): width, height, warm_frames (set-up
frames, on a scratch accumulator), trace_frames (frames in a traced run).
The first frame id of the window comes from the seed.

End-to-end numbers: mrays_s (width x height x bounces x 2 rays a frame,
over the window from its start to the last frame's completion) and
frame_ms_p95 (the 95th percentile of the frames' completion intervals).
`correct`: at pixels drawn from the seed, the accumulator the window
produced against the plain reference's accumulation of the same frames.
"""
from __future__ import annotations

import statistics

import torch

FIRST_FRAME_SPAN = 1 << 23  # frame ids stay exact in float32's count


def first_frame(seed: int, warm: int) -> int:
    return warm + seed % FIRST_FRAME_SPAN


class Render:
    unit = "frame"

    def __init__(self, ctx):
        from portbench.harness import port
        self.ctx = ctx
        t = ctx.traffic
        self.width, self.height = int(t["width"]), int(t["height"])
        self.bounces = int(ctx.config["bounces"])
        self.scene, camera = port.scene_and_camera(ctx.desc, ctx.device)
        self.cam = camera.raygen_params(self.width, self.height, ctx.device)
        self.options = port.render_options(self.scene)
        self.s0 = first_frame(ctx.seed, int(t["warm_frames"]))
        self.trace_units = int(t["trace_frames"])
        self.accum = None
        self.frames = 0

    def frame(self, accum, s):
        from optixpathtracer_tpu_torch.integrate import path
        return path.render_chunk(self.scene, *self.cam, self.width,
                                 self.height, accum, s, 1, self.bounces,
                                 "auto", **self.options)

    def warm_up(self):
        scratch = torch.zeros((self.height, self.width, 3),
                              device=self.ctx.device)
        warm = int(self.ctx.traffic["warm_frames"])
        for s in range(self.s0 - warm, self.s0):
            scratch = self.frame(scratch, s)

    def window(self, clock, more):
        """Frames from s0 while more() holds; returns the end-to-end
        numbers."""
        accum = torch.zeros((self.height, self.width, 3),
                            device=self.ctx.device)
        clock.start()
        while True:
            accum = self.frame(accum, self.s0 + clock.units)
            clock.unit_done()
            if not more(clock.units):
                break
        seconds, steps = clock.finish()
        self.accum, self.frames = accum, clock.units
        rays = self.width * self.height * self.bounces * 2 * self.frames
        out = {"mrays_s": rays / seconds / 1e6}
        if len(steps) >= 20:
            out["frame_ms_p95"] = statistics.quantiles(
                steps, n=20)[-1] * 1e3
        return out

    def check(self):
        """{number: value} of the window's accumulator against the
        reference at `check_pixels` pixels drawn from the seed. Frees the
        program's state first."""
        px, py = self.sample_pixels()
        got = self.accum[py, px].clone()
        self.accum = self.scene = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        want = self.reference(px, py, "float32")
        return compare(got, want, float(self.ctx.workload["pixel_rtol"]))

    def sample_pixels(self):
        """(px, py) of distinct pixels drawn from the seed: `check_pixels`,
        or fewer where the window's frames times them pass `check_lanes`
        (so that the reference's time stays bounded as the program gets
        faster), but never under `min_pixels`."""
        dev = self.ctx.device
        w = self.ctx.workload
        g = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        n = min(int(w["check_pixels"]), self.width * self.height,
                max(int(w["min_pixels"]),
                    int(w["check_lanes"]) // max(self.frames, 1)))
        flat = torch.randperm(self.width * self.height, generator=g,
                              device=dev)[:n]
        return flat % self.width, flat // self.width

    def reference(self, px, py, precision):
        """The reference's accumulator of the window's frames at (px, py)."""
        from portbench.reference import scene as ref_scene
        from portbench.reference import shade
        dev = self.ctx.device
        rs = ref_scene.flatten(self.ctx.desc, dev)
        cam = ref_scene.camera_params(self.ctx.desc["camera"], self.width,
                                      self.height, dev)
        return shade.accumulate(rs, cam, self.width, self.height, px, py,
                                self.s0, self.frames, self.bounces,
                                shade.Precision(precision))


def compare(got, want, rtol):
    """bad_pixel_share: the share of pixels whose largest channel gap
    exceeds rtol times the larger of that pixel's brightest reference
    channel and a thousandth of the mean one; mean_rel_err: the summed
    absolute gap over the summed reference."""
    want_max = want.abs().amax(dim=-1)
    floor = 1e-3 * want_max.mean()
    gap = (got - want).abs().amax(dim=-1)
    bad = gap > rtol * torch.maximum(want_max, floor)
    bad = bad | ~torch.isfinite(got).all(dim=-1)
    total = want.abs().sum().clamp(min=1e-30)
    return {"bad_pixel_share": float(bad.float().mean()),
            "mean_rel_err": float(torch.nan_to_num(
                (got - want).abs(), nan=float("inf")).sum() / total)}


def make(ctx):
    return Render(ctx)
