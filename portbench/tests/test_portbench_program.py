"""The port's own spans in the trace arithmetic (`harness/program.py`), on
synthetic events: device ops and host syncs charged to the innermost
`tracer.*` span open at their launch, device time conserved, an idle gap
that opens while a synchronisation waits charged to it, the benchmark's
old numbers untouched by the program's spans, and the four readers of the
program's layers silent on a trace without those spans."""
import dataclasses
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench.harness import program
from portbench.harness.profile import Record, reduce
from portbench.harness.registry import Registry
from portbench.harness.spans import ISECT, SHADE, WINDOW

READERS = ("host_syncs_per_frame.render", "sync_idle_ms_per_frame.render",
           "isect_glue_ms_per_frame.render", "bsdf_ms_per_frame.render")


def host(name, a, b, corr=0):
    return Record(False, name, a, b, corr)


def dev(name, a, b, corr):
    return Record(True, name, a, b, corr)


SPANS = [
    host("tracer.frame", 100, 9000),
    host("tracer.bounce", 200, 8000),
    host("tracer.isect.closest", 300, 2000),
    host("tracer.isect.order", 300, 500),
    host("tracer.isect.kernel", 600, 800),
    host("tracer.shade", 2100, 7000),
    host("tracer.bsdf.f", 2200, 3000),
    host("tracer.bsdf.sample", 3100, 4000),
]
RUNTIME = [
    host(WINDOW, 0, 10000),
    host(ISECT, 250, 2050),
    host(SHADE, 2050, 7050),
    host("cudaLaunchKernel", 350, 351, 1),    # in order, in closest
    host("cudaLaunchKernel", 700, 701, 2),    # in the kernel span
    host("cudaLaunchKernel", 900, 901, 3),    # in closest itself
    host("cudaStreamSynchronize", 1000, 1500),  # in closest
    host("cudaLaunchKernel", 2300, 2301, 4),  # in bsdf.f
    host("cudaLaunchKernel", 3200, 3201, 5),  # in bsdf.sample
    host("cudaMemcpyAsync", 3300, 3301, 6),   # in bsdf.sample
    host("cudaStreamSynchronize", 3400, 3900),  # in bsdf.sample
    host("cudaLaunchKernel", 8500, 8501, 7),  # in the frame only
    host("cudaLaunchKernel", 9500, 9501, 8),  # outside every span
    host("cudaDeviceSynchronize", 9600, 9700),  # outside every span
]
DEVICE = [
    dev("k_order", 400, 600, 1),
    dev("k_walk", 800, 1200, 2),
    dev("k_glue", 1600, 1700, 3),    # the gap before it opened in a sync
    dev("k_f", 2400, 2600, 4),       # the gap before it opened in no sync
    dev("k_sample", 3250, 3350, 5),
    dev("Memcpy DtoH", 3350, 3450, 6),  # then idle while the sync waits
    dev("k_frame", 8600, 8700, 7),
    dev("k_late", 9600, 10100, 8),   # clipped at the window
]


def trace_of(records, units=1):
    return reduce(records, units, "frame")


def test_program_spans_leave_the_old_numbers_unchanged():
    old = trace_of(RUNTIME + DEVICE, 2)
    new = trace_of(RUNTIME + DEVICE + SPANS, 2)
    assert dataclasses.asdict(new) == dataclasses.asdict(old)


def test_innermost_span_takes_ops_and_syncs():
    p = program.reduce_program(RUNTIME + DEVICE + SPANS)
    s = p.spans
    assert {n: v.count for n, v in s.items()} == {r.name: 1 for r in SPANS}
    ns = {n: round(v.device_s * 1e9) for n, v in s.items()}
    assert ns == {"tracer.frame": 100, "tracer.bounce": 0,
                  "tracer.isect.closest": 100, "tracer.isect.order": 200,
                  "tracer.isect.kernel": 400, "tracer.shade": 0,
                  "tracer.bsdf.f": 200, "tracer.bsdf.sample": 200}
    assert s["tracer.bsdf.sample"].launches == 1  # the copy is no launch
    assert s["tracer.isect.kernel"].launches == 1
    assert {n: v.syncs for n, v in s.items() if v.syncs} == {
        "tracer.isect.closest": 1, "tracer.bsdf.sample": 1}


def test_device_time_is_conserved():
    p = program.reduce_program(RUNTIME + DEVICE + SPANS)
    total = sum(min(r.end_ns, 10000) - max(r.start_ns, 0) for r in DEVICE)
    charged = sum(v.device_s for v in p.spans.values()) + p.outside_device_s
    assert charged == pytest.approx(total * 1e-9)
    assert p.outside_device_s == pytest.approx(400e-9)


def test_gap_opened_during_a_sync_is_sync_idle():
    p = program.reduce_program(RUNTIME + DEVICE + SPANS)
    idle = {n: round(v.sync_idle_s * 1e9) for n, v in p.spans.items()
            if v.sync_idle_s}
    # 1200-1600: opened at 1200, inside the sync 1000-1500; 3450-8600:
    # opened inside the sync 3400-3900. The gap 1700-2400 opened in no
    # sync, the one after k_frame before the outside sync began.
    assert idle == {"tracer.isect.closest": 400, "tracer.bsdf.sample": 5150}


def _fake_profile(records):
    """A torch.profiler.profile whose kineto events are `records`, each
    with the device-side mirror that a user-scope range would have."""
    class Event:
        def __init__(self, r):
            self.r = r

        def device_type(self):
            return DeviceType.CUDA if self.r.device else DeviceType.CPU

        def name(self):
            return self.r.name

        def start_ns(self):
            return self.r.start_ns

        def duration_ns(self):
            return self.r.end_ns - self.r.start_ns

        def correlation_id(self):
            return self.r.correlation

    mirrors = [dev(r.name, r.start_ns, r.end_ns, 0) for r in records
               if not r.device and r.name.startswith(("tracer.",
                                                      "portbench."))]
    events = [Event(r) for r in records + mirrors]
    prof = object.__new__(torch.profiler.profile)
    prof.profiler = types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events))
    return prof


def test_records_drop_mirrors_and_keep_program_spans():
    recs = program.records_from_kineto(_fake_profile(
        RUNTIME + DEVICE + SPANS + [host("aten::add", 1, 2)]))
    assert sorted(r.name for r in recs if r.device) == sorted(
        r.name for r in DEVICE)
    assert sorted(r.name for r in recs if not r.device) == sorted(
        r.name for r in RUNTIME + SPANS if r.name not in (ISECT, SHADE))


def _read(name, trace, prof):
    """A reader called as `run_cell` calls it: by a caller that holds the
    run's profiler."""
    assert prof is None or isinstance(prof, torch.profiler.profile)
    return Registry().reader(name)(trace)


def test_readers():
    prof = _fake_profile(RUNTIME + DEVICE + SPANS)
    trace = trace_of(RUNTIME + DEVICE + SPANS, 2)
    got = {n: _read(n, trace, prof) for n in READERS}
    assert got == pytest.approx({
        "host_syncs_per_frame.render": 1.0,
        "sync_idle_ms_per_frame.render": 5550e-6 / 2,
        "isect_glue_ms_per_frame.render": 300e-6 / 2,
        "bsdf_ms_per_frame.render": 400e-6 / 2})


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_program_spans(name):
    records = RUNTIME + DEVICE
    assert _read(name, trace_of(records), _fake_profile(records)) is None
    assert _read(name, trace_of(records + SPANS), None) is None


def test_reader_span_names_are_the_ports():
    from optixpathtracer_tpu_torch import spans
    reg = Registry()
    glue = reg.reader("isect_glue_ms_per_frame.render").__globals__
    bsdf = reg.reader("bsdf_ms_per_frame.render").__globals__
    assert glue["KERNEL"] in spans.NAMES
    assert any(n.startswith(glue["ISECT"]) for n in spans.NAMES)
    assert set(bsdf["BSDF"]) <= set(spans.NAMES)
    assert all(n.startswith(program.PREFIX) for n in spans.NAMES)
