"""The port's live viewer (``optix_renderer_tpu_torch.engine.serve``) over HTTP
on a 32^2 CPU render: the seven tests of tests/integration/test_serve.py
against the port's ``ViewerServer`` (port 0, NORMALS), malformed control
requests refused, the orbit math against the JAX ``OrbitCamera``, two
tests of a frame in flight, and a stress test of control ops from more
threads than cores.

Ordering comes from events and from polling a condition, never from a
sleep that hopes a thread got somewhere: the stand-in renderer and the
gated real renderer signal when a frame has started, and every wait has a
deadline of its own (the suite has no pytest-timeout).
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from io import BytesIO

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.serve import OrbitCamera as JOrbitCamera
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.engine.serve import SWITCH_INTERVAL_S, OrbitCamera, ViewerServer
from optix_renderer_tpu_torch.scene import SceneCamera, parse_scene, write_cornell_scene

torch.set_num_threads(2)

RES = 32
DEADLINE = 60.0  # seconds for any one wait


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    scene_path = write_cornell_scene(str(tmp_path_factory.mktemp("cornell_serve")))
    r = Renderer(parse_scene(scene_path), width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    s = ViewerServer(r, scene_path=scene_path, port=0, out_dir=str(tmp_path_factory.mktemp("shots")))
    s.start()
    yield s
    s.shutdown()
    assert s.error is None and not any(t.is_alive() for t in s._threads)


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=DEADLINE) as f:
        return f.read()


def _status(server) -> dict:
    return json.loads(_get(server, "/status"))


def _post(server, body):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/control", data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=DEADLINE) as f:
        return json.loads(f.read())


def _wait_until(cond, what: str, timeout: float = DEADLINE):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.02)
    raise TimeoutError(f"{what}: not within {timeout} s")


def _wait_spp(server, n):
    _wait_until(lambda: _status(server)["accum_id"] >= n, f"accum_id >= {n}")


def test_page_and_frame(server):
    page = _get(server, "/")
    assert b"optix_renderer_tpu" in page
    _wait_spp(server, 1)
    png = _get(server, "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    status = _status(server)
    assert status["mode_name"] == "Normals"
    assert status["width"] == RES


def test_mode_switch_resets_accum(server):
    _wait_spp(server, 1)
    assert _post(server, {"op": "mode", "mode": int(RendererType.MASK)})["ok"]
    status = _status(server)
    assert status["mode"] == int(RendererType.MASK) and status["accum_id"] == 0  # right after the op
    _wait_spp(server, 1)  # re-renders in the new mode
    # MASK of a closed box is all-white -> PNG of constant 1.0
    from PIL import Image

    img = np.asarray(Image.open(BytesIO(_get(server, "/frame.png"))))
    assert (img[..., :3] == 255).all()
    assert _post(server, {"op": "mode", "mode": int(RendererType.NORMALS)})["ok"]
    _wait_spp(server, 1)


def test_orbit_changes_camera_and_restarts(server):
    _wait_spp(server, 1)
    before = np.array(server.cam.from_)
    assert _post(server, {"op": "orbit", "daz": 0.5, "del": 0.0})["ok"]
    after = np.array(server.cam.from_)
    assert not np.allclose(before, after)
    # distance to the look-at point is preserved by orbiting
    r0 = np.linalg.norm(before - server.cam.at)
    r1 = np.linalg.norm(after - server.cam.at)
    assert abs(r0 - r1) < 1e-6 * max(r0, 1.0)
    _wait_spp(server, 1)
    assert np.array_equal(server.r.state.camera.pos.numpy(), after.astype(np.float32))
    assert _post(server, {"op": "reset"})["ok"]
    assert np.allclose(server.cam.from_, before)
    _wait_spp(server, 1)


def test_record_camera_appends_to_scene_json(server):
    with open(server.scene_path) as f:
        n_before = len(json.load(f).get("cameras", []))
    assert _post(server, {"op": "record"})["ok"]
    with open(server.scene_path) as f:
        cams = json.load(f)["cameras"]
    assert len(cams) == n_before + 1
    assert set(cams[-1]) == {"from", "to", "up", "cos_fovy"}


def test_screenshot(server):
    _wait_spp(server, 1)
    out = _post(server, {"op": "screenshot"})
    assert out["ok"]
    with open(out["path"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_malformed_control_is_refused(server):
    """A body that is not JSON, an op with a bad argument or a mode that
    does not exist: 400, ``ok`` false, nothing changed, and the viewer goes
    on answering."""
    epoch = _status(server)["epoch"]
    for body in (b"{not json", json.dumps({"op": "mode", "mode": 99}).encode(),
                 json.dumps({"op": "orbit", "daz": "left"}).encode(), json.dumps(["orbit"]).encode()):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/control", data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=DEADLINE)
        assert e.value.code == 400 and json.loads(e.value.read())["ok"] is False
    assert _status(server)["epoch"] == epoch
    assert _post(server, {"op": "nope"}) == {"ok": False, "error": "unknown op 'nope'"}


def _mk_cam():
    return SceneCamera(from_=np.array([0.0, 0.0, 5.0], np.float32), at=np.zeros(3, np.float32),
                       up=np.array([0.0, 1.0, 0.0], np.float32), cos_fovy=0.66)


def test_orbit_camera_math():
    cam = OrbitCamera(_mk_cam())
    v0 = cam.from_ - cam.at
    cam.orbit(np.pi / 2, 0.0)
    v1 = cam.from_ - cam.at
    assert abs(np.linalg.norm(v0) - np.linalg.norm(v1)) < 1e-9
    assert abs(float(np.dot(v0, v1))) < 1e-6 * float(np.dot(v0, v0))  # 90 deg
    cam.zoom(0.5)
    assert abs(np.linalg.norm(cam.from_ - cam.at) - 0.5 * np.linalg.norm(v1)) < 1e-9


def test_orbit_camera_matches_jax():
    """The same orbit, zoom, pan and reset sequence on both packages'
    OrbitCamera: the same float64 look-at state, and the same float32
    SceneCamera out."""
    ops = [("orbit", (0.3, 0.2)), ("zoom", (0.8,)), ("pan", (12.0, -7.0)), ("orbit", (-1.1, -0.4)),
           ("orbit", (0.0, 2.0)), ("zoom", (1.3,)), ("pan", (-3.0, 5.5))]
    got, want = OrbitCamera(_mk_cam()), JOrbitCamera(_mk_cam())
    for op, args in ops:
        getattr(got, op)(*args)
        getattr(want, op)(*args)
        for f in ("from_", "at", "up"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{op}: {f}")
    a, b = got.as_scene_camera(), want.as_scene_camera()
    for f in ("from_", "at", "up"):
        assert getattr(a, f).dtype == np.float32
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    got.reset()
    np.testing.assert_array_equal(got.from_, np.float64(_mk_cam().from_))


class _SlowFakeRenderer:
    """Renderer stand-in whose frames take ``frame_s`` seconds (a
    terrain-class scene) and signal when each one starts: /status and
    /control must answer while a frame is in flight, and a camera op
    mid-frame must drop that frame instead of committing it."""

    class _State:
        def __init__(self, accum_id):
            self.accum = torch.zeros((1, 1, 3))
            self.accum_id = accum_id

    def __init__(self, frame_s=1.5):
        self.frame_s = frame_s
        self.width = self.height = 8
        self.device = torch.device("cpu")
        self.mode = RendererType.PATH
        self.state = self._State(0)
        self.scene = type("S", (), {"cameras": [_mk_cam()]})()
        self.metrics = {"mrays_per_sec": 0.0}
        self.commits = 0
        self.cameras_set = 0
        self.started = [threading.Event() for _ in range(64)]
        self.frames = 0

    def render_step_detached(self):
        self.started[self.frames].set()
        self.frames += 1
        time.sleep(self.frame_s)
        return self._State(self.state.accum_id + 1), None, {}

    def commit_step(self, state, gb, aux, seconds):
        self.state = state
        self.commits += 1

    def set_camera(self, cam):
        self.cameras_set += 1
        self.state = self._State(0)

    def set_mode(self, mode):
        self.mode = mode
        self.state = self._State(0)


def test_serve_nonblocking_while_frame_in_flight(tmp_path):
    r = _SlowFakeRenderer(frame_s=1.5)
    s = ViewerServer(r, port=0, out_dir=str(tmp_path))
    interval = sys.getswitchinterval()
    s.start()
    try:
        assert sys.getswitchinterval() == min(interval, SWITCH_INTERVAL_S)
        assert r.started[0].wait(DEADLINE)  # a 1.5 s frame is now in flight
        lat = []
        for _ in range(4):
            t0 = time.perf_counter()
            _status(s)
            lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = _post(s, {"op": "orbit", "daz": 0.1, "del": 0.0})
        lat.append(time.perf_counter() - t0)
        assert out["ok"]
        assert r.frames == 1 and not r.started[1].is_set()  # still the first frame
        # every request answered while the frame was still rendering
        assert max(lat) < 0.5, lat
        assert _status(s)["accum_id"] == 0
        # the in-flight frame raced the orbit op: it must be DROPPED (the
        # next frame starts only after the render thread applied the camera)
        assert r.started[1].wait(DEADLINE)
        assert r.commits == 0 and s.discarded == 1 and r.cameras_set == 1
        assert r.state.accum_id == 0 and _status(s)["accum_id"] == 0
    finally:
        s.shutdown()
    assert s.error is None and sys.getswitchinterval() == interval


class _GatedRenderer(Renderer):
    """A real renderer whose detached frames wait for ``gate`` while
    ``hold`` is set, after signalling ``held``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hold = True
        self.held = threading.Event()
        self.gate = threading.Event()

    def render_step_detached(self):
        frame = super().render_step_detached()
        if self.hold:
            self.held.set()
            self.gate.wait(DEADLINE)
        return frame


def test_control_op_drops_a_real_frame_in_flight(tmp_path):
    """A real PATH frame held in flight while an orbit lands: it is
    dropped, the state stays valid, and the next committed frame is
    accum_id 1 from the new camera."""
    scene = parse_scene(write_cornell_scene(str(tmp_path / "scene")))
    r = _GatedRenderer(scene, width=RES, height=RES, mode=RendererType.PATH, path_depth=2, device="cpu")
    s = ViewerServer(r, port=0, out_dir=str(tmp_path))
    s.start()
    try:
        assert r.held.wait(DEADLINE)  # frame 1 of epoch 0 is rendered and held
        out = _post(s, {"op": "orbit", "daz": 0.4, "del": 0.1})
        assert out["ok"] and out["epoch"] == 1 and _status(s)["accum_id"] == 0
        moved = s.cam.as_scene_camera().from_
        r.hold = False
        r.gate.set()
        _wait_until(lambda: s.commits and s.commits[-1][1] >= 2, "two frames of the new camera")
        assert s.discarded == 1
        assert [c[:2] for c in list(s.commits)[:2]] == [(1, 1), (1, 2)]  # no frame of epoch 0 committed
        assert np.array_equal(r.state.camera.pos.numpy(), moved)
        img = r.image()
        assert np.isfinite(img).all() and img.mean() > 0
    finally:
        r.gate.set()
        s.shutdown()
    assert s.error is None


def test_concurrent_control_ops_lose_no_update(tmp_path):
    """More control threads than cores, with a short switch interval, while
    frames render: every op bumps the epoch exactly once, and the first
    frame committed after the last op renders the orbit camera's final
    position."""
    scene = parse_scene(write_cornell_scene(str(tmp_path / "scene")))
    r = Renderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=1, device="cpu")
    s = ViewerServer(r, port=0, out_dir=str(tmp_path))
    n_threads, n_ops = 2 * (os.cpu_count() or 2) + 1, 25
    old = sys.getswitchinterval()
    s.start()
    try:
        sys.setswitchinterval(1e-6)

        def worker(k):
            for i in range(n_ops):
                msg = {"op": "orbit", "daz": 0.01 * (k + 1), "del": 0.0} if i % 2 else {"op": "zoom", "f": 1.001}
                assert s.control(msg)["ok"]

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE)
        assert not any(t.is_alive() for t in threads)
        sys.setswitchinterval(old)
        last = n_threads * n_ops
        assert s.epoch == last
        _wait_until(lambda: any(c[0] == last for c in list(s.commits)), "a frame after the last op")
        assert np.array_equal(r.state.camera.pos.numpy(), s.cam.as_scene_camera().from_)
    finally:
        sys.setswitchinterval(old)
        s.shutdown()
    assert s.error is None
