"""Device ms a frame of the kernels launched inside `_shade_wave`, less
those inside its nested intersection spans (the NEE shadow query)."""
from portbench.harness.spans import SHADE


def read(trace):
    if trace.unit != "frame" or trace.units == 0 or not trace.span_s[SHADE]:
        return None
    return trace.span_s[SHADE] * 1e3 / trace.units
