"""Interactive progressive preview: browser viewport + fly camera (port of
`optixpathtracer_tpu/preview.py`, rendering with the port's
`render_chunk` on the scene's device, one frame at a time).

The replacement for the reference's OpenGL window + GLFW input layer
(`source/Renderer/{OpenGLWindow,OptixView}.cpp`, SURVEY.md L6/L7): instead
of a GL swapchain, a small stdlib HTTP server streams the sRGB-encoded
accumulation buffer as PNG to a browser page, and the page posts key/drag
input back. Semantics mirror the reference view loop:

  * 1-spp frames accumulate into a running mean while the camera is still
    (`AddPathtracedFrame.frag:13-25` endless mode),
  * any camera motion resets the accumulator and the sample counter
    (`OptixView.cpp:141-151`),
  * WASD + space/shift move along the camera basis, drag rotates with the
    pitch clamped to +/-80 degrees (`OptixView.cpp:22-25,48-85`),
  * a heartbeat reports "at Sample: N" every 10 samples
    (`OptixView.cpp:159-161`).

Run: python -m optixpathtracer_tpu_torch.cli --scene scene3_cornell \
        --preview 8000
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

MOVE_SPEED = 2.0   # world units / s (reference cameraSpeed, OptixView.cpp:49)
ROT_SPEED = 0.25   # degrees / pixel dragged (reference 0.3, OptixView.cpp:19)
PITCH_LIMIT = 80.0

_PAGE = """<!doctype html>
<html><head><title>optixpathtracer_tpu_torch preview</title><style>
body { background: #111; color: #ccc; font-family: monospace; margin: 1em; }
img  { image-rendering: pixelated; width: %WIDTH%px; cursor: grab; }
</style></head><body>
<div>optixpathtracer_tpu_torch &mdash; WASD move, Q/E down/up, drag to look.
<span id=stat></span></div>
<img id=view draggable=false>
<script>
const img = document.getElementById('view');
const stat = document.getElementById('stat');
const keys = new Set();
let drag = null;
addEventListener('keydown', e => keys.add(e.key.toLowerCase()));
addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
addEventListener('mouseup', () => { drag = null; });
addEventListener('mousemove', e => {
  if (!drag) return;
  post({dx: e.clientX - drag[0], dy: e.clientY - drag[1]});
  drag = [e.clientX, e.clientY];
});
function post(extra) {
  fetch('/input', {method: 'POST', body: JSON.stringify(
      Object.assign({keys: [...keys]}, extra))});
}
setInterval(() => { if (keys.size) post({}); }, 50);
function refresh() {
  fetch('/state').then(r => r.json()).then(s => {
    stat.textContent = ' sample ' + s.samples + ' | ' +
        s.spp_per_s.toFixed(2) + ' spp/s';
    img.src = '/frame.png?t=' + s.version;
    setTimeout(refresh, 100);
  }).catch(() => setTimeout(refresh, 500));
}
refresh();
</script></body></html>"""


def _encode_png(linear_img):
    """Linear [H,W,3] (a tensor or an array; film row 0 = bottom) -> sRGB
    PNG bytes, through the film's display transform."""
    from PIL import Image

    from .film import to_display
    buf = io.BytesIO()
    Image.fromarray(to_display(linear_img)[::-1]).save(buf, format="PNG")
    return buf.getvalue()


class PreviewState:
    """Camera + accumulator shared between the render loop and HTTP
    handlers. The render loop owns the device arrays; handlers only mutate
    the camera/input fields under the lock."""

    def __init__(self, camera):
        self.lock = threading.Lock()
        self.camera = camera
        self.moved = False
        self.samples = 0
        self.version = 0
        self.png = b""
        self.spp_per_s = 0.0
        self.running = True

    def apply_input(self, keys, dx, dy, dt):
        with self.lock:
            cam = self.camera
            fwd = cam.forward()
            right = np.cross(fwd, cam.world_up)
            right /= max(np.linalg.norm(right), 1e-9)
            step = MOVE_SPEED * dt
            delta = np.zeros(3)
            if "w" in keys:
                delta += fwd * step
            if "s" in keys:
                delta -= fwd * step
            if "a" in keys:
                delta -= right * step
            if "d" in keys:
                delta += right * step
            if " " in keys or "e" in keys:
                delta += cam.world_up * step
            if "shift" in keys or "q" in keys:
                delta -= cam.world_up * step
            if np.any(delta != 0.0):
                cam.position = cam.position + delta
                self.moved = True
            if dx or dy:
                # reference: yaw += dx, pitch += dy, pitch clamped
                # (`OptixView.cpp:12-31`)
                cam.rotation = cam.rotation.astype(np.float64).copy()
                cam.rotation[1] += dx * ROT_SPEED
                cam.rotation[0] = float(np.clip(
                    cam.rotation[0] + dy * ROT_SPEED,
                    -PITCH_LIMIT, PITCH_LIMIT))
                self.moved = True


def _make_handler(state, width):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with state.lock:
                    png = state.png
                self._send(200, "image/png", png or b"")
            elif self.path.startswith("/state"):
                with state.lock:
                    body = json.dumps({
                        "samples": state.samples,
                        "version": state.version,
                        "spp_per_s": state.spp_per_s}).encode()
                self._send(200, "application/json", body)
            else:
                page = _PAGE.replace("%WIDTH%", str(max(width * 2, 512)))
                self._send(200, "text/html", page.encode())

        def do_POST(self):
            # Reject cross-origin POSTs: the server binds localhost, but a
            # hostile page could still POST to it from the browser. Browsers
            # always send Host; require it to be local.
            host = (self.headers.get("Host") or "").split(":")[0]
            if host not in ("127.0.0.1", "localhost", "[::1]"):
                self._send(403, "application/json", b'{"error":"bad host"}')
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                msg = {}
            state.apply_input(set(msg.get("keys", [])),
                              float(msg.get("dx", 0.0)),
                              float(msg.get("dy", 0.0)), dt=0.05)
            self._send(200, "application/json", b"{}")

    return Handler


def run_preview(scene, camera, width=256, height=256, max_bounces=2,
                intersect_method="auto", port=8000, max_seconds=None,
                reference_compat=False):
    """Serve the interactive preview; blocks until interrupted (or
    max_seconds). Returns the final accumulated image."""
    from .integrate.cutout import scene_uses_alpha_cutout
    from .integrate.path import render_chunk
    from .scene.flatten import (scene_active_lobes, scene_flat_shading,
                                scene_uses_textures)

    lobes = scene_active_lobes(scene)
    use_tex = scene_uses_textures(scene)
    flat = scene_flat_shading(scene)
    use_cutout = scene_uses_alpha_cutout(scene)

    state = PreviewState(camera)
    server = ThreadingHTTPServer(("127.0.0.1", port),
                                 _make_handler(state, width))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"preview at http://127.0.0.1:{port}/ "
          f"({width}x{height}, {max_bounces} bounces)", flush=True)

    device = scene.device
    accum = torch.zeros((height, width, 3), device=device)
    t_start = time.time()
    t_mark = t_start
    samples_mark = 0
    try:
        while state.running:
            with state.lock:
                if state.moved:           # camera motion resets accumulation
                    accum = torch.zeros_like(accum)
                    state.samples = 0
                    samples_mark = 0
                    t_mark = time.time()
                    state.moved = False
                # Snapshot the raygen params while still holding the lock:
                # HTTP handlers mutate position/rotation in place under it,
                # so reading them outside could tear the camera matrix.
                pos, iv, ip = state.camera.raygen_params(width, height,
                                                         device)
                s = state.samples
            accum = render_chunk(scene, pos, iv, ip, width, height, accum,
                                 s, 1, max_bounces, intersect_method,
                                 reference_compat, lobes, use_tex,
                                 use_cutout, flat_shading=flat)
            png = _encode_png(accum)
            now = time.time()
            with state.lock:
                state.samples = s + 1
                state.version += 1
                state.png = png
                if now > t_mark:
                    state.spp_per_s = (state.samples - samples_mark) / (
                        now - t_mark)
            if (s + 1) % 10 == 0:
                print(f"at Sample: {s + 1}", flush=True)
            if max_seconds is not None and now - t_start > max_seconds:
                break
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return accum
