"""Device ms a frame of the intersection layer's plain-torch glue: the ops
launched inside the port's `tracer.isect.*` spans other than
`tracer.isect.kernel` (coherence order and ray gathers, candidate sort,
unsort and hit record, refinement), innermost span first. None where the
port opens no such span."""
from portbench.harness import program

ISECT = "tracer.isect."
KERNEL = "tracer.isect.kernel"


def read(trace):
    prog = program.of(trace)
    if prog is None or not any(n.startswith(ISECT) for n in prog.spans):
        return None
    return program.per_unit(trace, 1e3 * sum(
        s.device_s for n, s in prog.spans.items()
        if n.startswith(ISECT) and n != KERNEL))
