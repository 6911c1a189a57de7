"""The trace arithmetic on synthetic events: busy time as the union of
device intervals, kernels attributed to the span open at their launch
(intersection nested in shading counts for intersection), copies not
counted as launches, idle gaps labelled by what the host launched next."""
import pytest

from portbench.harness.profile import Record, reduce, union
from portbench.harness.spans import ISECT, SHADE, WINDOW


def host(name, a, b, corr=0):
    return Record(False, name, a, b, corr)


def dev(name, a, b, corr):
    return Record(True, name, a, b, corr)


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_reduce_attributes_and_unions():
    rec = [
        host(WINDOW, 0, 1000),
        host(SHADE, 100, 600),
        host(ISECT, 200, 300),
        # launches (runtime calls) and their kernels
        host("cudaLaunchKernel", 50, 51, 1),   # outside every span
        host("cudaLaunchKernel", 150, 151, 2),  # in shading
        host("cudaLaunchKernel", 250, 251, 3),  # in intersection in shading
        host("cudaMemcpyAsync", 700, 701, 4),
        host("cudaLaunchKernel", 800, 801, 5),
        dev("k_outside", 60, 160, 1),
        dev("k_shade", 160, 260, 2),            # back to back with the first
        dev("k_isect", 400, 500, 3),
        dev("Memcpy HtoD", 705, 725, 4),
        dev("k_late", 900, 1100, 5),             # clipped at the window
        host("aten::add", 10, 20),                # ignored host op
    ]
    t = reduce(rec, units=2, unit="frame")
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((200 + 100 + 20 + 100) * 1e-9)
    assert t.launches == 4
    assert t.span_s[ISECT] == pytest.approx(100e-9)
    assert t.span_s[SHADE] == pytest.approx(100e-9)
    assert t.idle_share == pytest.approx(1 - 420 / 1000)
    assert [n for n, _ in t.device_ops][:2] == ["k_outside", "k_shade"]
    gaps = dict(t.idle_gaps)
    assert gaps[f"{ISECT}, before k_isect"] == pytest.approx(140e-9)
    assert gaps["outside spans, before k_late"] == pytest.approx(175e-9)
    assert gaps["outside spans, before k_outside"] == pytest.approx(60e-9)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_reduce_needs_the_window_span():
    with pytest.raises(ValueError):
        reduce([dev("k", 0, 1, 1)], 1, "frame")
