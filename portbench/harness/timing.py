"""Completion times of the window's units (frames or fitting steps).

On the card each unit is marked by a CUDA event recorded on the stream
right after the unit's work, and the window's start by one recorded after a
synchronise: times are the device's own, and the host never waits between
units. The CPU tests drive the same code with host-clock marks."""
from __future__ import annotations

import time

import torch


class UnitClock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.marks = [self._mark()]

    def unit_done(self):
        self.marks.append(self._mark())

    @property
    def units(self) -> int:
        return len(self.marks) - 1

    def finish(self):
        """Wait for the device; returns (window seconds from the start to the
        last unit's completion, [seconds of each unit's completion
        interval])."""
        if self.cuda:
            torch.cuda.synchronize()

            def ms(a, b):
                return a.elapsed_time(b)
        else:
            def ms(a, b):
                return (b - a) * 1e3
        steps = [ms(a, b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return ms(self.marks[0], self.marks[-1]) / 1e3, steps
