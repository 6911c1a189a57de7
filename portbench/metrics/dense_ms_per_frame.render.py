"""Device ms a frame of the dense engine's sweeps: the ops launched with
the port's `tracer.dense` span innermost (`intersect/dense_kernels.py`,
`dense_closest_kernel` and `dense_any_kernel` of
`csrc/dense_intersect.cu` and their output buffers). None where the port
opens no such span: a scene of too many walk chunks for the dense engine,
or a version of the port without the span."""
from portbench.harness import program

DENSE = "tracer.dense"


def read(trace):
    prog = program.of(trace)
    if prog is None or DENSE not in prog.spans:
        return None
    return program.per_unit(trace, 1e3 * prog.spans[DENSE].device_s)
