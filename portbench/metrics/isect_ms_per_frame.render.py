"""Device ms a frame of the kernels launched inside the intersection spans
(closest and shadow queries, their sorts and permutations included)."""
from portbench.harness.spans import ISECT


def read(trace):
    if trace.unit != "frame" or trace.units == 0 or not trace.span_s[ISECT]:
        return None
    return trace.span_s[ISECT] * 1e3 / trace.units
