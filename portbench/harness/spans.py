"""The benchmark's spans around the port's layers, recorded from the
benchmark's own files: while `installed()` is open, the calls of
`integrate/path.py` into the intersection queries (closest, any and their
cutout chains) run inside `portbench.isect` ranges and `_shade_wave` inside
`portbench.shade`, as torch.profiler ranges. The NEE shadow query runs
inside `_shade_wave`, so its isect range nests in a shade range."""
from __future__ import annotations

import contextlib
import functools

ISECT = "portbench.isect"
SHADE = "portbench.shade"
WINDOW = "portbench.window"

_WRAPPED = {"intersect_closest": ISECT, "intersect_any": ISECT,
            "intersect_closest_cutout": ISECT,
            "intersect_any_cutout": ISECT, "_shade_wave": SHADE}


def _wrap(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


@contextlib.contextmanager
def installed():
    from optixpathtracer_tpu_torch.integrate import path
    saved = {k: getattr(path, k) for k in _WRAPPED}
    for k, name in _WRAPPED.items():
        setattr(path, k, _wrap(saved[k], name))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(path, k, fn)
