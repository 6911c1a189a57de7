"""Device ms a frame of the BSDF lobes: the ops launched inside the port's
`tracer.bsdf.f` (NEE's evaluation) and `tracer.bsdf.sample` spans. None
where the port opens no such span."""
from portbench.harness import program

BSDF = ("tracer.bsdf.f", "tracer.bsdf.sample")


def read(trace):
    prog = program.of(trace)
    if prog is None or not any(n in prog.spans for n in BSDF):
        return None
    return program.per_unit(trace, 1e3 * sum(
        prog.spans[n].device_s for n in BSDF if n in prog.spans))
