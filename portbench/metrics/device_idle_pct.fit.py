"""Percent of the traced window of fitting steps in which no operation ran
on the device: 1 - union of device activity intervals / window."""


def read(trace):
    if trace.unit != "step" or trace.busy_s <= 0:
        return None
    return 100.0 * trace.idle_share
