"""Layer spans on the torch profiler's clock.

`span(NAME)` opens a range named NAME on the profiler's host timeline
while a torch.profiler is recording (`cli.py --profile`, a benchmark's
traced run), and does nothing otherwise: the guard costs a fraction of a
microsecond, so the spans stay in the main path. Kernels launched inside a
range, and the host runtime calls made in it (launches, copies,
synchronisations), fall on the same kineto timeline, through the
profiler's correlation of each launch with its kernel, so a reader of the
trace can charge device time, launches and host syncs to the innermost
open span. `traced(NAME)` opens the span around every call of a function.

The ranges are of the profiler's function scope, not its user scope
(`torch.profiler.record_function`): a user-scope range also gets a mirror
on the device timeline (`gpu_user_annotation`) covering its kernels, which
a reader that sums device events would count as work.

Spans sit at layer boundaries only, never inside a loop over lanes or the
steps of a walk: a frame makes about 20 a bounce.
"""
from __future__ import annotations

import contextlib
import functools

import torch

FRAME = "tracer.frame"              # one frame: render_sample + accumulate
RAYGEN = "tracer.raygen"            # camera rays and pixel seeds
BOUNCE = "tracer.bounce"            # ray sort, intersection and shading
ISECT_CLOSEST = "tracer.isect.closest"  # api.intersect_closest, whole
ISECT_ANY = "tracer.isect.any"      # api.intersect_any, whole
ISECT_ORDER = "tracer.isect.order"  # coherence key, argsort, ray gathers
ISECT_KERNEL = "tracer.isect.kernel"  # a hand-written kernel (or plain)
# a packet sweep, inside ISECT_KERNEL; its name lies outside
# "tracer.isect.", whose spans other than ISECT_KERNEL read as glue
PACKET = "tracer.packet"
# a dense sweep, inside ISECT_KERNEL, and outside "tracer.isect." as PACKET
DENSE = "tracer.dense"
ISECT_CANDIDATES = "tracer.isect.candidates"  # candidate sort and count
ISECT_UNSORT = "tracer.isect.unsort"  # back to lane order, hit record
ISECT_REFINE = "tracer.isect.refine"  # differentiable re-intersection
CUTOUT = "tracer.cutout"            # the alpha-cutout re-trace chains
SHADE = "tracer.shade"              # the shading of one wave
SURFACE = "tracer.surface"          # make_surface
NEE = "tracer.nee"                  # light pick, shadow query, NEE f
BSDF_F = "tracer.bsdf.f"            # dispatch.f: every active lobe
BSDF_SAMPLE = "tracer.bsdf.sample"  # dispatch.sample: every active lobe
ADVANCE = "tracer.advance"          # throughput and ray update

NAMES = (FRAME, RAYGEN, BOUNCE, ISECT_CLOSEST, ISECT_ANY, ISECT_ORDER,
         ISECT_KERNEL, PACKET, DENSE, ISECT_CANDIDATES, ISECT_UNSORT,
         ISECT_REFINE, CUTOUT, SHADE, SURFACE, NEE, BSDF_F, BSDF_SAMPLE,
         ADVANCE)

_NULL = contextlib.nullcontext()
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return _range(name)
    return _NULL


def traced(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
