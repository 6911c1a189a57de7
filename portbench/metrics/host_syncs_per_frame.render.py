"""Host synchronisations a frame made inside the port's `tracer.*` spans:
runtime calls that wait for the device (a blocking copy of a host scalar
to the card, a copy to the host, an explicit synchronise), each of which
drains the stream. None where the port opens no such span."""
from portbench.harness import program


def read(trace):
    prog = program.of(trace)
    if prog is None:
        return None
    return program.per_unit(trace, sum(s.syncs
                                       for s in prog.spans.values()))
