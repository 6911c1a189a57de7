"""Kernel launches a frame (copies and sets not counted), over the traced
frames: the wavefront layer's launch count, which sets the host's pace."""


def read(trace):
    if trace.unit != "frame" or trace.units == 0 or trace.launches == 0:
        return None
    return trace.launches / trace.units
