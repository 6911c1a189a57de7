"""The port's `tracer.*` layer spans (`optixpathtracer_tpu_torch/spans.py`)
on the CPU: under torch.profiler every frame of `render_chunk` holds its
bounces, and every bounce its intersection and shading spans; without a
profiler no range is opened; the image does not depend on the profiler.
The walk and dense engines run their plain versions here, inside the same
spans as their kernels on the card."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from optixpathtracer_tpu_torch import spans
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.integrate.cutout import \
    scene_uses_alpha_cutout
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.flatten import scene_active_lobes
from optixpathtracer_tpu_torch.scene.procedural import (scene_cornell,
                                                         scene_hall,
                                                         scene_material_test)

torch.set_num_threads(1)

SIZE = 16
BOUNCES = 3
FRAMES = 2
# Spans a bounce on the walk engine: the bounce; the closest query with
# its order, two kernels, candidate sort, two unsorts, hit record and
# refine; shading, surface, NEE, the shadow query (order, two kernels,
# candidate sort, unsort), BSDF f and sample, advance.
SPANS_PER_BOUNCE = 22


@pytest.fixture(scope="module")
def diffuse():
    model, camera, lights = scene_material_test("diffuse", segments=(6, 12))
    scene = flatten_model(model, lights, device="cpu")
    return scene, camera.raygen_params(SIZE, SIZE, "cpu")


def _frames(diffuse):
    scene, cam = diffuse
    accum = torch.zeros((SIZE, SIZE, 3))
    return path.render_chunk(scene, *cam, SIZE, SIZE, accum, 5, FRAMES,
                             BOUNCES, "walk",
                             active_lobes=scene_active_lobes(scene),
                             use_alpha_cutout=scene_uses_alpha_cutout(scene))


def _profiled(diffuse):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        accum = _frames(diffuse)
    ranges = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("tracer.")]
    return accum, ranges


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_frames_hold_bounces_hold_layers(diffuse):
    _, ranges = _profiled(diffuse)
    assert {n for n, _, _ in ranges} <= set(spans.NAMES)
    frames = [r for r in ranges if r[0] == spans.FRAME]
    bounces = [r for r in ranges if r[0] == spans.BOUNCE]
    assert len(frames) == FRAMES
    assert len(bounces) == FRAMES * BOUNCES
    for b in bounces:
        assert sum(_inside(b, f) for f in frames) == 1
    layers = [r for r in ranges
              if r[0].startswith("tracer.isect.") or r[0] == spans.SHADE]
    names = {n for n, _, _ in layers}
    assert names == {spans.ISECT_CLOSEST, spans.ISECT_ANY, spans.ISECT_ORDER,
                     spans.ISECT_KERNEL, spans.ISECT_CANDIDATES,
                     spans.ISECT_UNSORT, spans.ISECT_REFINE, spans.SHADE}
    for r in layers:
        assert sum(_inside(r, b) for b in bounces) == 1, r
    for name in (spans.BSDF_F, spans.BSDF_SAMPLE, spans.SURFACE, spans.NEE,
                 spans.ADVANCE):
        shaded = [r for r in ranges if r[0] == name]
        assert len(shaded) == FRAMES * BOUNCES, name
        assert all(any(_inside(r, s) for s in layers if s[0] == spans.SHADE)
                   for r in shaded)
    # the shadow query runs inside NEE, inside shading
    for r in ranges:
        if r[0] == spans.ISECT_ANY:
            assert any(_inside(r, n) for n in ranges if n[0] == spans.NEE)
    for b in bounces:
        assert sum(_inside(r, b) for r in ranges) == SPANS_PER_BOUNCE


def test_spans_are_function_scope_ranges():
    """Not user annotations: the profiler mirrors those on the device
    timeline, where a reader that sums device events would count them as
    work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span(spans.FRAME):
            torch.ones(4).sum()
    found = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == spans.FRAME]
    assert len(found) == 1 and not found[0].is_user_annotation()


def test_no_range_without_a_profiler(diffuse, monkeypatch):
    opened = []
    real = spans._range

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(spans, "_range", counted)
    _frames(diffuse)
    assert opened == []
    _profiled(diffuse)
    assert opened.count(spans.FRAME) == FRAMES


def test_profiler_leaves_the_image_unchanged(diffuse):
    plain = _frames(diffuse)
    traced, _ = _profiled(diffuse)
    assert plain.abs().sum() > 0
    assert torch.equal(plain, traced)


ISECT_NAMES = {spans.ISECT_CLOSEST, spans.ISECT_ANY, spans.ISECT_ORDER,
               spans.ISECT_KERNEL, spans.ISECT_CANDIDATES, spans.ISECT_UNSORT,
               spans.ISECT_REFINE}


def _hall_frame(hall, profiled):
    """One frame of the cut hall with every query on the packet engine:
    closest and occlusion queries, on the opaque scene and in the cutout
    chains over the foliage."""
    scene, cam = hall
    accum = torch.zeros((8, 8, 3))

    def frame():
        return path.render_chunk(
            scene, *cam, 8, 8, accum, 3, 1, 2, "packet",
            active_lobes=scene_active_lobes(scene), use_textures=True,
            use_alpha_cutout=scene_uses_alpha_cutout(scene))

    if not profiled:
        return frame(), []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        image = frame()
    ranges = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("tracer.")]
    return image, ranges


def test_packet_span_inside_the_kernel_span():
    model, camera, lights = scene_hall(0.1)
    scene = flatten_model(model, lights, device="cpu")
    hall = scene, camera.raygen_params(8, 8, "cpu")
    assert scene_uses_alpha_cutout(scene)
    plain, _ = _hall_frame(hall, profiled=False)
    traced, ranges = _hall_frame(hall, profiled=True)
    assert plain.abs().sum() > 0
    assert torch.equal(plain, traced)
    assert {n for n, _, _ in ranges} <= set(spans.NAMES)
    assert {n for n, _, _ in ranges
            if n.startswith("tracer.isect.")} <= ISECT_NAMES
    assert not spans.PACKET.startswith("tracer.isect.")
    packets = [r for r in ranges if r[0] == spans.PACKET]
    kernels = [r for r in ranges if r[0] == spans.ISECT_KERNEL]
    queries = [r for r in ranges
               if r[0] in (spans.ISECT_CLOSEST, spans.ISECT_ANY)]
    assert packets
    holders = set()
    for p in packets:
        assert any(_inside(p, k) for k in kernels), p
        holders |= {q[0] for q in queries if _inside(p, q)}
    assert holders == {spans.ISECT_CLOSEST, spans.ISECT_ANY}
    assert any(_inside(p, c) for p in packets for c in ranges
               if c[0] == spans.CUTOUT)


def _cornell_ranges(method):
    """The `tracer.*` ranges of one 8x8 Cornell frame with every query on
    the engine `method`, and its image."""
    model, camera, lights = scene_cornell()
    scene = flatten_model(model, lights, device="cpu")
    cam = camera.raygen_params(8, 8, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        image = path.render_chunk(scene, *cam, 8, 8, torch.zeros((8, 8, 3)),
                                  3, 1, 2, method,
                                  active_lobes=scene_active_lobes(scene))
    ranges = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("tracer.")]
    return image, sorted(ranges, key=lambda r: r[1])


@pytest.mark.parametrize("method", ["pallas", "walk"])
def test_dense_span_inside_the_kernel_span(method):
    """A Cornell frame on the dense engine ("pallas", which the card's
    router picks for a scene of fewer than 8 walk chunks) opens
    `tracer.dense` in every query's kernel span, once a closest and once a
    shadow query a bounce; on the walk engine it opens none."""
    image, ranges = _cornell_ranges(method)
    assert image.abs().sum() > 0
    assert {n for n, _, _ in ranges} <= set(spans.NAMES)
    assert not spans.DENSE.startswith("tracer.isect.")
    dense = [r for r in ranges if r[0] == spans.DENSE]
    if method == "walk":
        assert dense == []
        return
    kernels = [r for r in ranges if r[0] == spans.ISECT_KERNEL]
    queries = [r for r in ranges
               if r[0] in (spans.ISECT_CLOSEST, spans.ISECT_ANY)]
    assert len(dense) == len(kernels) == len(queries) == 4
    for k, q in zip(dense, queries):
        assert sum(_inside(k, c) for c in kernels) == 1, k
        assert _inside(k, q)
    assert [q[0] for q in queries] == [spans.ISECT_CLOSEST,
                                       spans.ISECT_ANY] * 2
