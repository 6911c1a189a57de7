"""From a torch.profiler trace to the numbers the per-layer metrics read.

The arithmetic is chip_smoke.py's `device_profile` (the raw kineto events
are summed: `key_averages()` takes ~60 us an event), with two changes:
the device's busy time is the union of its activity intervals, not their
sum, and each kernel is attributed to the benchmark span that was open on
the host when the kernel was launched, through the profiler's correlation
of a kernel with its runtime launch call. A kernel launched inside an
intersection span counts for intersection; one inside a shading span and
in no nested intersection span counts for shading.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

from .spans import ISECT, SHADE, WINDOW

COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Record:
    """One trace event: on the device (a kernel, copy or set) or on the
    host (a runtime call or a benchmark span)."""
    device: bool
    name: str
    start_ns: int
    end_ns: int
    correlation: int = 0


@dataclasses.dataclass
class Trace:
    units: int            # frames or steps in the traced window
    unit: str             # "frame" or "step"
    window_s: float       # the traced window, from its span
    busy_s: float         # union of device activity inside it
    launches: int         # kernels (copies and sets excluded)
    span_s: dict          # {ISECT: s, SHADE: s exclusive of ISECT}
    device_ops: list      # [[name, s]] the 10 heaviest by total time
    idle_gaps: list       # [[what the host was doing, s]] the 10 largest

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def records_from_kineto(prof) -> list:
    """The raw events of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() == DeviceType.CUDA
        name = ev.name()
        if dev and name in (ISECT, SHADE, WINDOW):
            continue  # a span's mirror on the device timeline, no work
        if not dev and name not in (ISECT, SHADE, WINDOW) \
                and not name.startswith("cu"):
            continue  # only spans and runtime calls matter on the host
        start = ev.start_ns()
        out.append(Record(dev, name, start, start + ev.duration_ns(),
                          ev.correlation_id()))
    return out


class _Intervals:
    """Non-overlapping [start, end] ranges of one span name."""

    def __init__(self, ranges):
        ranges = sorted(ranges)
        self.starts = [a for a, _ in ranges]
        self.ends = [b for _, b in ranges]

    def __contains__(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def short(name: str, width: int = 100) -> str:
    """A kernel's name without the namespaces that every ATen kernel
    repeats, cut to `width` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "std::array<char*, "):
        name = name.replace(noise, "")
    return name[:width]


def union(intervals):
    """Merged [start, end] intervals of a list of them."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(records, units: int, unit: str) -> Trace:
    window = [r for r in records if not r.device and r.name == WINDOW]
    if not window:
        raise ValueError("the trace holds no window span")
    w0, w1 = window[0].start_ns, window[0].end_ns
    spans = {n: _Intervals([(r.start_ns, r.end_ns) for r in records
                            if not r.device and r.name == n])
             for n in (ISECT, SHADE)}
    launch_at = {r.correlation: r.start_ns for r in records
                 if not r.device and r.name.startswith("cu")}

    def where(rec):
        t = launch_at.get(rec.correlation)
        if t is None:
            return None, None
        for n in (ISECT, SHADE):  # innermost first
            if t in spans[n]:
                return n, t
        return "", t

    device = [r for r in records if r.device
              and r.end_ns > w0 and r.start_ns < w1]
    span_ns = defaultdict(int)
    by_name = defaultdict(int)
    launches = 0
    for r in device:
        dur = min(r.end_ns, w1) - max(r.start_ns, w0)
        by_name[short(r.name)] += dur
        if not r.name.startswith(COPY_PREFIXES):
            launches += 1
        span, _ = where(r)
        if span:
            span_ns[span] += dur
    busy = union([(max(r.start_ns, w0), min(r.end_ns, w1)) for r in device])
    gaps = defaultdict(int)
    busy_starts = [b[0] for b in busy]
    first_of = {}  # busy interval -> the first device op in it
    for r in sorted(device, key=lambda r: r.start_ns):
        i = bisect.bisect_right(busy_starts, max(r.start_ns, w0)) - 1
        first_of.setdefault(i, r)
    edges = [w0] + [b for iv in busy for b in iv] + [w1]
    for i in range(len(busy) + 1):
        gap = edges[2 * i + 1] - edges[2 * i]
        if gap <= 0:
            continue
        nxt = first_of.get(i)
        if nxt is None:
            label = "after the last device op"
        else:
            span, t = where(nxt)
            host = {None: "unattributed", "": "outside spans", ISECT: ISECT,
                    SHADE: SHADE}[span]
            label = f"{host}, before {short(nxt.name, 70)}"
        gaps[label] += gap
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        units=units, unit=unit, window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9, launches=launches,
        span_s={n: span_ns[n] / 1e9 for n in (ISECT, SHADE)},
        device_ops=[[n, v / 1e9] for n, v in top],
        idle_gaps=[[n, v / 1e9] for n, v in idle])
