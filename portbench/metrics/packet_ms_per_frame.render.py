"""Device ms a frame of the packet engine's sweeps: the ops launched with
the port's `tracer.packet` span innermost (`intersect/packet_kernels.py`,
the two kernels of `csrc/packet_intersect.cu` and their output buffers).
None where the port opens no such span: a scene of too few walk chunks
for the packet engine, or a version of the port without the span."""
from portbench.harness import program

PACKET = "tracer.packet"


def read(trace):
    prog = program.of(trace)
    if prog is None or PACKET not in prog.spans:
        return None
    return program.per_unit(trace, 1e3 * prog.spans[PACKET].device_s)
