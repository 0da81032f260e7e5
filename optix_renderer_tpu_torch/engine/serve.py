"""Live viewer: a local HTTP loop over the progressive renderer (counterpart
of ``optix_renderer_tpu/engine/serve.py``; the reference's GLFW/ImGui loop,
include/viewer.hpp:65-148, 659-845).

The page, its ops and its JSON are the JAX viewer's: /status, /frame.png,
POST /control with orbit, zoom, pan, reset, mode, record (append the camera
to the scene JSON) and screenshot.  What differs is who touches the device:

* A control op changes host state only, under ``lock``: the orbit camera,
  the pending camera or mode, the epoch, and what ``/status`` shows
  (``accum_id`` reads 0 right after a camera or mode op).  The render thread
  applies the pending camera and mode to the Renderer before its next frame,
  so no HTTP thread enqueues device work behind a frame in flight.
* The render thread renders each frame outside the lock from one snapshot
  (``Renderer.render_step_detached``), on a CUDA stream of its own, waits
  for that frame only (an event recorded after it), and commits it under
  the lock unless a control op changed the epoch meanwhile; a stale frame is
  dropped, and since a frame leaves its input state as it was, the renderer
  stays valid (the JAX viewer's donated state does not: ROADMAP.md C).
  On a card each frame is a replay of the renderer's frame graph, captured
  on this thread when a mode switch makes a new key; a camera move keeps
  it.  The frame is a clone of the graph's outputs, and the renderer's
  frame slot orders this stream against any other user of its buffers.
* ``/status`` reads host figures only: the committed ``accum_id``, the
  frame rate and the honest Mrays/s the render thread reads after each
  commit, when its frame is done; while the viewer runs, the interpreter
  hands its lock to a waiting HTTP thread within ``SWITCH_INTERVAL_S``.  ``/frame.png`` and the screenshot copy
  the committed accumulator to the host on the HTTP thread's stream: a
  committed frame is complete, so the copy waits for no frame in flight.
"""

from __future__ import annotations

import collections
import io
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from ..scene.config import SceneCamera
from ..utils.log import get_logger
from .modes import DETERMINISTIC_MODES, RENDERER_NAMES, RendererType

log = get_logger("serve")

# While the viewer runs, a thread that waits for the interpreter lock asks
# the render thread for it after this long (Python's default is 5 ms).  On
# the card the render thread holds the lock between thousands of short
# launches a frame, and an HTTP answer needs the lock several times, so at
# 5 ms a /status answer could take tens of ms; at 1 ms it takes a few.  It
# costs nothing while no request waits.
SWITCH_INTERVAL_S = 0.001


_PAGE = """<!doctype html>
<html><head><title>optix_renderer_tpu_torch</title><style>
body { background: #111; color: #ddd; font: 13px monospace; margin: 12px; }
#img { image-rendering: pixelated; border: 1px solid #333; cursor: grab; }
button { background: #222; color: #ddd; border: 1px solid #444; margin: 1px;
         font: 12px monospace; cursor: pointer; }
button.active { background: #375; }
#bar { margin: 6px 0; }
</style></head><body>
<div id="modes"></div>
<div id="bar">connecting…</div>
<img id="img" width="%W%" height="%H%">
<div>drag: orbit &nbsp; wheel: zoom &nbsp; shift+drag: pan &nbsp; arrows: orbit
&nbsp; 0-9: mode &nbsp; R: record cam &nbsp; P: screenshot &nbsp; space: reset</div>
<script>
const img = document.getElementById('img'), bar = document.getElementById('bar');
let busy = false;
async function ctl(body) {
  await fetch('/control', {method: 'POST', body: JSON.stringify(body)});
}
async function tick() {
  if (!busy) {
    busy = true;
    try {
      const s = await (await fetch('/status')).json();
      bar.textContent = `${s.mode_name}  spp=${s.accum_id}  ` +
        `${s.fps.toFixed(1)} fps  ${s.mrays.toFixed(1)} Mrays/s  ${s.width}x${s.height}`;
      document.querySelectorAll('#modes button').forEach(b =>
        b.classList.toggle('active', +b.dataset.m === s.mode));
      const r = await fetch('/frame.png?t=' + Date.now());
      const b = await r.blob();
      const url = URL.createObjectURL(b);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
    } catch (e) {}
    busy = false;
  }
  setTimeout(tick, 250);
}
fetch('/status').then(r => r.json()).then(s => {
  const div = document.getElementById('modes');
  s.mode_names.forEach((n, i) => {
    const b = document.createElement('button');
    b.textContent = i + ':' + n; b.dataset.m = i;
    b.onclick = () => ctl({op: 'mode', mode: i});
    div.appendChild(b);
  });
});
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY, e.shiftKey]; e.preventDefault(); };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY, drag[2]];
  ctl(drag[2] ? {op: 'pan', dx: dx, dy: dy} : {op: 'orbit', daz: -dx * 0.01, del: dy * 0.01});
};
img.onwheel = e => { ctl({op: 'zoom', f: e.deltaY > 0 ? 1.1 : 0.9}); e.preventDefault(); };
window.onkeydown = e => {
  if (e.key >= '0' && e.key <= '9') ctl({op: 'mode', mode: +e.key});
  else if (e.key === 'ArrowLeft') ctl({op: 'orbit', daz: 0.1, del: 0});
  else if (e.key === 'ArrowRight') ctl({op: 'orbit', daz: -0.1, del: 0});
  else if (e.key === 'ArrowUp') ctl({op: 'orbit', daz: 0, del: 0.1});
  else if (e.key === 'ArrowDown') ctl({op: 'orbit', daz: 0, del: -0.1});
  else if (e.key === ' ') ctl({op: 'reset'});
  else if (e.key === 'r' || e.key === 'R') ctl({op: 'record'});
  else if (e.key === 'p' || e.key === 'P') ctl({op: 'screenshot'});
};
tick();
</script></body></html>"""


def _png_bytes(img: np.ndarray) -> bytes:
    """Tonemap (pow 1/2.2, save_images.py:12-17) + vertical flip -> PNG."""
    from PIL import Image

    u8 = (np.clip(img[::-1], 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="PNG")
    return buf.getvalue()


class OrbitCamera:
    """Host-side look-at state with orbit/pan/zoom ops (the OWLViewer
    camera manipulator's role)."""

    def __init__(self, cam: SceneCamera):
        self.home = cam
        self.reset()

    def reset(self):
        self.from_ = np.asarray(self.home.from_, np.float64).copy()
        self.at = np.asarray(self.home.at, np.float64).copy()
        self.up = np.asarray(self.home.up, np.float64).copy()
        self.cos_fovy = float(self.home.cos_fovy)

    def as_scene_camera(self) -> SceneCamera:
        return SceneCamera(
            from_=self.from_.astype(np.float32),
            at=self.at.astype(np.float32),
            up=self.up.astype(np.float32),
            cos_fovy=self.cos_fovy,
        )

    def orbit(self, daz: float, dele: float):
        v = self.from_ - self.at
        r = np.linalg.norm(v)
        upn = self.up / np.linalg.norm(self.up)
        # azimuth about up
        c, s = np.cos(daz), np.sin(daz)
        v = v * c + np.cross(upn, v) * s + upn * np.dot(upn, v) * (1 - c)
        # elevation about the right axis, clamped off the poles
        right = np.cross(v, upn)
        rn = np.linalg.norm(right)
        if rn > 1e-9:
            right /= rn
            c, s = np.cos(dele), np.sin(dele)
            v2 = v * c + np.cross(right, v) * s + right * np.dot(right, v) * (1 - c)
            cosang = np.dot(v2 / np.linalg.norm(v2), upn)
            if abs(cosang) < 0.995:
                v = v2
        self.from_ = self.at + v / np.linalg.norm(v) * r

    def zoom(self, f: float):
        self.from_ = self.at + (self.from_ - self.at) * f

    def pan(self, dx: float, dy: float):
        v = self.at - self.from_
        d = np.linalg.norm(v)
        fwd = v / d
        right = np.cross(fwd, self.up)
        right /= np.linalg.norm(right)
        upv = np.cross(right, fwd)
        step = d * 0.002
        delta = (-dx * right + dy * upv) * step
        self.from_ += delta
        self.at += delta


class ViewerServer:
    """HTTP viewer over a ``Renderer``.  ``serve_forever`` blocks; ``start``
    runs the render loop and the HTTP server in background threads and
    ``shutdown`` stops and joins them (tests drive it that way)."""

    def __init__(self, renderer, scene_path: str | None = None,
                 host: str = "127.0.0.1", port: int = 8000,
                 out_dir: str = ".", max_spp: int = 0):
        self.r = renderer
        self.scene_path = scene_path
        self.out_dir = out_dir
        self.max_spp = max_spp  # 0 = accumulate forever
        self.cam = OrbitCamera(renderer.scene.cameras[0])
        # guards every field below; never held while the device works
        self.lock = threading.Lock()
        self.dirty = threading.Event()  # wakes the render loop
        self.stop = threading.Event()
        self.recorded: list[SceneCamera] = []
        self.epoch = 0  # bumped by every op that restarts accumulation
        self._pending: dict = {}  # "camera" / "mode" for the render thread to apply
        self._mode = renderer.mode  # the mode /status shows
        self._shown = (0, renderer.state.accum_id, renderer.state.accum)  # (epoch, accum_id, accum)
        self._fps = 0.0
        self._mrays = 0.0
        self._png: bytes = b""
        self._png_id = None
        self.discarded = 0  # frames dropped because a control op raced them
        self.commits = collections.deque(maxlen=1024)  # (epoch, accum_id, seconds) per committed frame
        self.error: BaseException | None = None  # what ended the render loop, if anything did
        self._threads: list[threading.Thread] = []
        self._switch_interval = None  # the interpreter's own, restored by shutdown

        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = _PAGE.replace("%W%", str(outer.r.width)).replace("%H%", str(outer.r.height))
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame.png":
                    self._send(200, outer.frame_png(), "image/png")
                elif path == "/status":
                    self._send(200, json.dumps(outer.status()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    out = outer.control(json.loads(self.rfile.read(n) or "{}"))
                except (ValueError, KeyError, TypeError, AttributeError) as e:  # malformed JSON or argument
                    self._send(400, json.dumps({"ok": False, "error": repr(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # -- state ------------------------------------------------------------
    def status(self) -> dict:
        """Host figures only: answering never waits for the device."""
        with self.lock:
            return {
                "mode": int(self._mode),
                "mode_name": RENDERER_NAMES[int(self._mode)],
                "mode_names": RENDERER_NAMES,
                "accum_id": self._shown[1],
                "width": self.r.width,
                "height": self.r.height,
                "fps": self._fps,
                "mrays": self._mrays,
                "epoch": self.epoch,
            }

    def frame_png(self) -> bytes:
        """The committed image as a PNG, made outside the lock (the copy to
        the host and the encode are the slow parts); cached per (epoch,
        accum_id)."""
        with self.lock:
            epoch, count, accum = self._shown
            if (epoch, count) == self._png_id:
                return self._png
        if count:
            img = (accum / count).cpu().numpy()
        else:
            img = np.zeros((self.r.height, self.r.width, 3), np.float32)
        png = _png_bytes(img)
        with self.lock:
            if self._shown[:2] == (epoch, count):  # still current
                self._png, self._png_id = png, (epoch, count)
        return png

    def _restart(self, **pending) -> None:
        """Under the lock: the render thread applies ``pending`` before its
        next frame; the frame in flight, if any, is dropped."""
        self._pending.update(pending)
        self.epoch += 1
        self._shown = (self.epoch, 0, None)

    def control(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "screenshot":
            path = os.path.join(self.out_dir, f"screenshot_{int(time.time())}.png")
            with open(path, "wb") as f:
                f.write(self.frame_png())
            log.info("screenshot -> %s", path)
            return {"ok": True, "path": path}
        with self.lock:
            if op in ("orbit", "zoom", "pan", "reset"):
                if op == "orbit":
                    self.cam.orbit(float(msg.get("daz", 0)), float(msg.get("del", 0)))
                elif op == "zoom":
                    self.cam.zoom(float(msg.get("f", 1.0)))
                elif op == "pan":
                    self.cam.pan(float(msg.get("dx", 0)), float(msg.get("dy", 0)))
                else:
                    self.cam.reset()
                self._restart(camera=self.cam.as_scene_camera())
            elif op == "mode":
                mode = RendererType(int(msg["mode"]))
                if mode != self._mode:  # the same mode keeps accumulating (Renderer.set_mode)
                    self._mode = mode
                    self._restart(mode=mode)
            elif op == "record":
                self.recorded.append(self.cam.as_scene_camera())
                n = self._flush_cameras()
                log.info("recorded camera #%d%s", len(self.recorded), f" -> {self.scene_path}" if n else "")
            else:
                return {"ok": False, "error": f"unknown op {op!r}"}
            epoch = self.epoch
        self.dirty.set()
        return {"ok": True, "epoch": epoch}

    def _flush_cameras(self) -> int:
        """viewer.hpp:826-839: append the just-recorded camera into the
        scene JSON's cameras[] (the ``R`` + ``F`` key pair, collapsed:
        every record flushes immediately)."""
        if not self.scene_path:
            return 0
        with open(self.scene_path) as f:
            doc = json.load(f)
        c = self.recorded[-1]
        doc.setdefault("cameras", []).append({
            "from": [float(x) for x in c.from_],
            "to": [float(x) for x in c.at],
            "up": [float(x) for x in c.up],
            "cos_fovy": float(c.cos_fovy),
        })
        with open(self.scene_path, "w") as f:
            json.dump(doc, f, indent=2)
        return 1

    # -- loops ------------------------------------------------------------
    def _render_loop(self):
        """Progressive accumulation: apply the pending ops, render one frame
        from a snapshot outside the lock, wait for it, commit it under the
        lock if no control op raced it (viewer.hpp:553-568's async launch
        and event loop)."""
        r = self.r
        stream = torch.cuda.Stream(r.device) if r.device.type == "cuda" else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(r.device))  # the renderer's tensors so far
        try:
            with torch.cuda.stream(stream):
                while not self.stop.is_set():
                    self.dirty.clear()
                    with self.lock:
                        epoch0 = self.epoch
                        pending, self._pending = self._pending, {}
                    if "mode" in pending:
                        r.set_mode(pending["mode"])
                    if "camera" in pending:
                        r.set_camera(pending["camera"])
                    count = r.state.accum_id
                    if (r.mode in DETERMINISTIC_MODES and count >= 1) or (self.max_spp and count >= self.max_spp):
                        self.dirty.wait(timeout=0.25)
                        continue
                    t0 = time.perf_counter()
                    frame = r.render_step_detached()
                    if stream is not None:  # this frame only, not every stream of the device
                        done = torch.cuda.Event()
                        done.record(stream)
                        done.synchronize()
                    dt = time.perf_counter() - t0
                    with self.lock:
                        if self.epoch != epoch0:  # a camera or mode op landed mid-frame
                            self.discarded += 1
                            continue
                        r.commit_step(*frame, dt)
                        state = frame[0]
                        self._shown = (epoch0, state.accum_id, state.accum)
                        self.commits.append((epoch0, state.accum_id, dt))
                        self._fps = 0.8 * self._fps + 0.2 * (1.0 / max(dt, 1e-9))
                    self._mrays = float(r.metrics["mrays_per_sec"])  # the frame is done: no wait
        except Exception as e:  # the loop's boundary: keep the reason, the HTTP side goes on answering
            self.error = e
            log.exception("render loop stopped")
        finally:
            if stream is not None:
                stream.synchronize()

    def start(self):
        self._switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(min(self._switch_interval, SWITCH_INTERVAL_S))
        self._threads = [
            threading.Thread(target=self._render_loop, name="viewer-render", daemon=True),
            threading.Thread(target=self.httpd.serve_forever, name="viewer-http", daemon=True),
        ]
        for t in self._threads:
            t.start()
        log.info("live viewer at http://%s:%d/", *self.httpd.server_address[:2])

    def shutdown(self, timeout: float = 60.0):
        """Stop both threads and close the socket; the render thread ends
        after its frame in flight."""
        self.stop.set()
        self.dirty.set()
        if self._threads:  # httpd.shutdown() waits for a serve_forever that start() began
            self.httpd.shutdown()
        for t in self._threads:
            t.join(timeout)
        self.httpd.server_close()
        if self._switch_interval is not None:
            sys.setswitchinterval(self._switch_interval)
            self._switch_interval = None

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.shutdown()
