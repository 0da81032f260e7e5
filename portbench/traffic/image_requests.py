"""Driver ``image_requests``: the offline user framing one image after
another.  A request's camera is the scene's camera turned about the
vertical axis through its target by a yaw in [-arc_deg, arc_deg], from a
low-discrepancy sequence with a seeded start.  A request is ``set_camera``
to it, ``render(frames_per_call)`` until ``frames_per_request`` frames are
accumulated, and the displayed image, ``Renderer.image()``, read back to
host memory.  Its reference answer is the plain reference's mean of the
same frames (PATH).

Parameters: ``arc_deg``, ``frames_per_request``, ``frames_per_call``
(default 1).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness.traffic import Request, orbit_camera, unnamed
from portbench.reference.render import render_pixels

WARM_FRAMES = 2  # a warm-up request: the key's eager frame, then a replay of its captured graph
_PHI = 0.6180339887498949


def cameras(traffic: dict, base_cam: tuple, seed: int):
    a = float(traffic["arc_deg"])
    u = np.random.default_rng(seed & (2 ** 64 - 1)).random()
    i = 0
    while True:
        yield orbit_camera(base_cam, a * (2.0 * ((u + i * _PHI) % 1.0) - 1.0))
        i += 1


def calls(traffic: dict) -> list[int]:
    """The ``render`` calls of one request."""
    n, per = int(traffic["frames_per_request"]), int(traffic.get("frames_per_call", 1))
    return [per] * (n // per) + ([n % per] if n % per else [])


def warm(r, traffic: dict, base_cam: tuple, pixels: np.ndarray) -> None:
    short = {**traffic, "frames_per_request": WARM_FRAMES, "frames_per_call": WARM_FRAMES}
    a = float(traffic["arc_deg"])
    for yaw in (0.5 * a, -0.5 * a):
        serve(r, short, Request(orbit_camera(base_cam, yaw)), pixels)


def serve(r, traffic: dict, req: Request, pixels: np.ndarray, mark=unnamed) -> Request:
    from optix_renderer_tpu_torch.scene.config import SceneCamera

    from_, at, up, cos_fovy = req.camera
    req.t0 = time.perf_counter()
    with mark("set_camera"):
        r.set_camera(SceneCamera(from_=from_, at=at, up=up, cos_fovy=cos_fovy))
    for n in calls(traffic):
        with mark("render"):
            r.render(n)
    with mark("readback"):
        img = r.image()
    req.t1 = time.perf_counter()
    req.frames = r.state.accum_id
    req.sample = img.reshape(-1, 3)[pixels].astype(np.float64)
    return req


def reference(scene, traffic: dict, cam, width: int, height: int, pixels: np.ndarray) -> np.ndarray:
    """The frames the traffic asked for, not the ones the renderer says it
    made, so a request that accumulated too few frames is off."""
    kw = traffic["renderer"]
    if kw["mode"] != "PATH":
        raise ValueError(f"the plain reference renders PATH, not {kw['mode']}")
    return render_pixels(scene, cam, width, height, pixels, int(traffic["frames_per_request"]),
                         path_depth=int(kw["path_depth"]))
