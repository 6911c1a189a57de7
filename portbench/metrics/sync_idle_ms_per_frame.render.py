"""Device idle ms a frame in gaps that opened while a host synchronisation
inside the port's `tracer.*` spans was waiting: the part of the idle time
that a drained stream costs. None where the port opens no such span."""
from portbench.harness import program


def read(trace):
    prog = program.of(trace)
    if prog is None:
        return None
    return program.per_unit(trace, 1e3 * sum(
        s.sync_idle_s for s in prog.spans.values()))
