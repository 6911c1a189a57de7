"""Host synchronisations a frame with the port's `tracer.cutout` span
innermost: the host's "any lane still open?" test of each re-trace round
of the alpha-cutout chains (`integrate/cutout.py`), each of which drains
the stream. The queries inside the chains count for their own spans.
None where the port opens no such span (a scene without alpha holes)."""
from portbench.harness import program

CUTOUT = "tracer.cutout"


def read(trace):
    prog = program.of(trace)
    if prog is None or CUTOUT not in prog.spans:
        return None
    return program.per_unit(trace, float(prog.spans[CUTOUT].syncs))
