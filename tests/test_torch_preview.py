"""The port's interactive preview (`optixpathtracer_tpu_torch/preview.py`)
against the JAX package's: the same input sequence (keys, drags, time
steps, made with numpy from a seed) gives the reference's camera state
exactly; the HTTP handler round-trips input, state and frames and rejects
a foreign Host; and `run_preview` renders Cornell on the CPU for about two
seconds on a free port, serves its PNG over HTTP, and returns the running
mean of the frames it rendered, bit for bit `render`'s of as many frames.
"""
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from optixpathtracer_tpu.camera import Camera as JCamera
from optixpathtracer_tpu.preview import PreviewState as JPreviewState
from optixpathtracer_tpu_torch import preview
from optixpathtracer_tpu_torch.camera import Camera
from optixpathtracer_tpu_torch.film import to_display
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.preview import (MOVE_SPEED, PITCH_LIMIT,
                                               ROT_SPEED, PreviewState,
                                               _make_handler)
from optixpathtracer_tpu_torch.scene import flatten_model
from optixpathtracer_tpu_torch.scene.procedural import PRESETS

torch.set_num_threads(1)

KEYS = ("w", "a", "s", "d", "e", "q", " ", "shift")


def _pose():
    return dict(position=np.array([1.0, 2.0, 3.0]),
                rotation=np.array([0.0, 90.0, 0.0]))


def test_input_sequence_gives_reference_camera():
    ours, theirs = PreviewState(Camera(**_pose())), \
        JPreviewState(JCamera(**_pose()))
    rng = np.random.default_rng(9)
    for _ in range(200):
        keys = {k for k in KEYS if rng.random() < 0.2}
        dx, dy = (float(v) for v in rng.normal(0.0, 40.0, 2)
                  * (rng.random() < 0.5))
        dt = float(rng.uniform(0.01, 0.1))
        for st in (ours, theirs):
            st.moved = False
            st.apply_input(keys, dx, dy, dt)
        assert ours.moved == theirs.moved
        np.testing.assert_array_equal(ours.camera.position,
                                      theirs.camera.position)
        np.testing.assert_array_equal(ours.camera.rotation,
                                      theirs.camera.rotation)
    assert abs(ours.camera.rotation[0]) <= PITCH_LIMIT


def test_wasd_and_pitch_clamp():
    st = PreviewState(Camera(**_pose()))
    fwd, p0 = st.camera.forward(), st.camera.position.copy()
    st.apply_input({"w"}, 0.0, 0.0, dt=0.5)
    np.testing.assert_allclose(st.camera.position - p0,
                               fwd * MOVE_SPEED * 0.5, atol=1e-9)
    assert st.moved
    st.apply_input(set(), 40.0, 1e6, dt=0.05)
    assert st.camera.rotation[1] == pytest.approx(90.0 + 40.0 * ROT_SPEED)
    assert st.camera.rotation[0] == PITCH_LIMIT
    st.moved = False
    st.apply_input(set(), 0.0, 0.0, dt=0.05)
    assert not st.moved


@pytest.fixture()
def server():
    st = PreviewState(Camera(**_pose()))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(st, 64))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield st, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def test_http_round_trip(server):
    st, base = server
    p0 = st.camera.position.copy()
    body = json.dumps({"keys": ["w"], "dx": 8.0, "dy": 0.0}).encode()
    req = urllib.request.Request(base + "/input", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=5) as resp:
        assert resp.status == 200
    assert st.moved and not np.allclose(st.camera.position, p0)
    assert st.camera.rotation[1] != 90.0
    st.samples = 12
    with urllib.request.urlopen(base + "/state", timeout=5) as resp:
        assert json.loads(resp.read())["samples"] == 12
    st.png = b"\x89PNG-fake"
    with urllib.request.urlopen(base + "/frame.png", timeout=5) as resp:
        assert resp.read() == b"\x89PNG-fake"
    with urllib.request.urlopen(base + "/", timeout=5) as resp:
        assert b"optixpathtracer_tpu_torch" in resp.read()


def test_http_rejects_foreign_host(server):
    st, base = server
    req = urllib.request.Request(base + "/input",
                                 data=json.dumps({"keys": ["w"]}).encode(),
                                 method="POST",
                                 headers={"Host": "evil.example"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=5)
    assert exc.value.code == 403
    assert not st.moved


def test_run_preview_renders_and_serves(monkeypatch, capsys):
    import socket
    model, camera, lights = PRESETS["scene3_cornell"]()
    scene = flatten_model(model, lights, device="cpu")
    states = []

    class Recorded(PreviewState):
        def __init__(self, cam):
            super().__init__(cam)
            states.append(self)

    monkeypatch.setattr(preview, "PreviewState", Recorded)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        img=preview.run_preview(scene, camera, 16, 16, 2, port=port,
                                max_seconds=2.0)))
    thread.start()
    png = b""
    deadline = time.monotonic() + 60
    while not png and time.monotonic() < deadline:
        time.sleep(0.1)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame.png",
                                        timeout=5) as resp:
                png = resp.read()
        except (urllib.error.URLError, ConnectionError):
            continue
    thread.join(60)
    assert not thread.is_alive()
    assert Image.open(io.BytesIO(png)).size == (16, 16)
    n = states[0].samples
    assert n > 0
    want = path.render(scene, camera, 16, 16, spp=n, max_bounces=2)
    np.testing.assert_array_equal(result["img"].numpy(), want.numpy())
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(states[0].png)))[::-1],
        to_display(want))
    out = capsys.readouterr().out
    assert f"preview at http://127.0.0.1:{port}/ (16x16, 2 bounces)" in out
    if n >= 10:
        assert "at Sample: 10" in out
