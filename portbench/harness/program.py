"""The port's own layer spans in a traced run: per-span statistics that the
per-layer metrics of the program's layers read.

The port opens `tracer.*` ranges on the profiler's host timeline
(`optixpathtracer_tpu_torch/spans.py`) while a profiler records. Each
device op is charged to the innermost `tracer.*` span open on the host
when the op was launched (through the profiler's correlation of an op
with its runtime call, as `profile.reduce` charges the benchmark's own
spans), and so is each host synchronisation: a runtime call that waits
for the device (`SYNC_CALLS`). An idle gap of the device that opens while
such a call is in progress is the wait that the drained stream costs; it
is charged to the span of that call.

`profile.Trace`, which the readers are handed, keeps only the benchmark's
spans; `of(trace)` reads the port's spans from the events of the profiler
that produced it, the `torch.profiler.profile` held by the caller that
hands the readers their trace (`run_cell`).
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
from collections import defaultdict

from .profile import COPY_PREFIXES, Record, union
from .spans import WINDOW

PREFIX = "tracer."
# Runtime calls that return only once the device has caught up: explicit
# synchronisations, and the blocking copy (a copy from pageable host
# memory made without `non_blocking` shows as cudaMemcpyAsync followed by
# cudaStreamSynchronize).
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


@dataclasses.dataclass
class SpanStats:
    count: int = 0          # spans of this name opened in the window
    device_s: float = 0.0   # device ops launched with it innermost
    launches: int = 0       # of those, kernels (copies and sets excluded)
    syncs: int = 0          # SYNC_CALLS started with it innermost
    sync_idle_s: float = 0.0  # device idle gaps opened during those calls


@dataclasses.dataclass
class Program:
    spans: dict             # {span name: SpanStats}
    outside_device_s: float  # device ops launched in no tracer span


def records_from_kineto(prof) -> list:
    """The events of a finished torch.profiler.profile that the per-span
    statistics need: device ops (without the device-side mirrors of host
    ranges), the host's runtime calls, the window span and the port's
    `tracer.*` spans."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() == DeviceType.CUDA
        name = ev.name()
        if dev and name.startswith(("portbench.", PREFIX)):
            continue  # a range's mirror on the device timeline, no work
        if not dev and name != WINDOW and not name.startswith(("cu",
                                                               PREFIX)):
            continue
        start = ev.start_ns()
        out.append(Record(dev, name, start, start + ev.duration_ns(),
                          ev.correlation_id()))
    return out


def _owners(spans, times):
    """The innermost span (an index into `spans`, or None) open at each of
    `times`. The spans nest as the host's call stack opens them; a time on
    a span's edge lies inside it."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    events = ([(spans[i].start_ns, 0, i) for i in order]
              + [(t, 1, k) for k, t in enumerate(times)]
              + [(spans[i].end_ns, 2, i) for i in order])
    events.sort(key=lambda e: (e[0], e[1]))
    owner = [None] * len(times)
    stack = []
    for _, kind, i in events:
        if kind == 0:
            stack.append(i)
        elif kind == 1:
            owner[i] = stack[-1] if stack else None
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
    return owner


def reduce_program(records) -> Program:
    """Per-span statistics of the `tracer.*` spans inside the window."""
    window = [r for r in records if not r.device and r.name == WINDOW]
    if not window:
        raise ValueError("the trace holds no window span")
    w0, w1 = window[0].start_ns, window[0].end_ns
    spans = [r for r in records if not r.device
             and r.name.startswith(PREFIX) and w0 <= r.start_ns <= w1]
    launch_at = {r.correlation: r.start_ns for r in records
                 if not r.device and r.name.startswith("cu")}
    device = [r for r in records if r.device
              and r.end_ns > w0 and r.start_ns < w1]
    syncs = sorted((r for r in records if not r.device
                    and r.name in SYNC_CALLS and w0 <= r.start_ns <= w1),
                   key=lambda r: r.start_ns)
    # a device op with no known launch call counts as launched at -1,
    # before every span: outside them all
    launched = [launch_at.get(r.correlation, -1) for r in device]
    owners = _owners(spans, launched + [r.start_ns for r in syncs])
    op_owner, sync_owner = owners[:len(device)], owners[len(device):]
    stats = defaultdict(SpanStats)
    for r in spans:
        stats[r.name].count += 1
    outside_ns = 0
    for r, i in zip(device, op_owner):
        dur = min(r.end_ns, w1) - max(r.start_ns, w0)
        if i is None:
            outside_ns += dur
            continue
        s = stats[spans[i].name]
        s.device_s += dur / 1e9
        if not r.name.startswith(COPY_PREFIXES):
            s.launches += 1
    for i in sync_owner:
        if i is not None:
            stats[spans[i].name].syncs += 1
    # idle gaps: from the end of each busy interval to the next one's start
    busy = union([(max(r.start_ns, w0), min(r.end_ns, w1)) for r in device])
    starts = [r.start_ns for r in syncs]
    for k, (_, opened) in enumerate(busy):
        closed = busy[k + 1][0] if k + 1 < len(busy) else w1
        j = bisect.bisect_right(starts, opened) - 1
        if closed <= opened or j < 0 or syncs[j].end_ns < opened:
            continue
        if sync_owner[j] is not None:
            stats[spans[sync_owner[j]].name].sync_idle_s += \
                (closed - opened) / 1e9
    return Program(dict(stats), outside_ns / 1e9)


def _caller_profile():
    """The torch.profiler.profile held by the nearest caller, or None."""
    from torch.profiler import profile
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, profile):
                return value
        frame = frame.f_back
    return None


def of(trace) -> Program | None:
    """The port's span statistics of the run that `trace` reduces, or None
    where the run's profiler cannot be found or the program opened no
    `tracer.*` span in the window (a version of the port without them).
    Computed once a trace and kept on it."""
    if "_program" not in vars(trace):
        prof = _caller_profile()
        program = None
        if prof is not None:
            program = reduce_program(records_from_kineto(prof))
            if not program.spans:
                program = None
        trace._program = program
    return trace._program


def per_unit(trace, value):
    """`value` over the trace's frames, or None for a trace of other units
    or one with no device activity."""
    if trace.unit != "frame" or trace.units == 0 or trace.busy_s <= 0:
        return None
    return value / trace.units
