"""Driver ``ratio_requests``: the offline user of the ratio estimator
(RATIO: analytic LTC direct light times the ratio of a shadowed to an
unshadowed stochastic estimate), saving the three buffers of one framing
after another for the offline combine, as the reference renderer's viewer
saves them (viewer.hpp:715-800) for ``ltc_ratio_estimator.py``.

A request's camera comes from ``image_requests.cameras`` (the scene's
camera turned within +-``arc_deg``).  A request is ``set_camera`` to it,
``render(frames_per_call)`` calls until ``frames_per_request`` frames are
rendered (the buffers are the mean over one call's frames, so a request is
one call), the three buffers ``ltc``, ``sto_direct`` and ``sto_no_vis`` read
back to host memory, and the user's combine ``ltc * D / N``
(``reference.ratio.combine``) at the run's sampled pixels, its answer.  Its
reference answer is the plain reference's buffers over the same frames,
combined alike (``reference.ratio``).

Parameters: ``arc_deg``, ``frames_per_request``, ``frames_per_call``
(equal: one call a request), and the renderer's ``ratio_samples``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness.traffic import Request, orbit_camera, unnamed
from portbench.reference.ratio import combine, render_ratio_pixels
from portbench.traffic.image_requests import calls, cameras  # noqa: F401 (the harness calls cameras)

WARM_FRAMES = 2  # a warm-up request: the key's eager frame, then a replay of its captured graph
BUFFERS = ("ltc", "sto_direct", "sto_no_vis")


def _one_call(traffic: dict) -> None:
    if len(calls(traffic)) != 1:
        raise ValueError("a RATIO request is one render call: its buffers are the mean over one call's frames "
                         f"(frames_per_request {traffic['frames_per_request']}, "
                         f"frames_per_call {traffic.get('frames_per_call', 1)})")


def warm(r, traffic: dict, base_cam: tuple, pixels: np.ndarray) -> None:
    short = {**traffic, "frames_per_request": WARM_FRAMES, "frames_per_call": WARM_FRAMES}
    a = float(traffic["arc_deg"])
    for yaw in (0.5 * a, -0.5 * a):
        serve(r, short, Request(orbit_camera(base_cam, yaw)), pixels)


def serve(r, traffic: dict, req: Request, pixels: np.ndarray, mark=unnamed) -> Request:
    from optix_renderer_tpu_torch.scene.config import SceneCamera

    _one_call(traffic)
    from_, at, up, cos_fovy = req.camera
    req.t0 = time.perf_counter()
    with mark("set_camera"):
        r.set_camera(SceneCamera(from_=from_, at=at, up=up, cos_fovy=cos_fovy))
    for n in calls(traffic):
        with mark("render"):
            r.render(n)
    with mark("readback"):
        bufs = {k: r.aux[k].cpu().numpy() for k in BUFFERS}
        ltc, d, n = (bufs[k].reshape(-1, bufs[k].shape[-1])[pixels] for k in BUFFERS)
        req.sample = combine(ltc, d[:, 0], n[:, 0])
    req.t1 = time.perf_counter()
    req.frames = r.state.accum_id
    return req


def reference(scene, traffic: dict, cam, width: int, height: int, pixels: np.ndarray) -> np.ndarray:
    """The frames the traffic asked for, not the ones the renderer says it
    made, so a request that rendered too few frames is off."""
    kw = traffic["renderer"]
    if kw["mode"] != "RATIO":
        raise ValueError(f"ratio_requests renders RATIO, not {kw['mode']}")
    _one_call(traffic)
    b = render_ratio_pixels(scene, cam, width, height, pixels, int(traffic["frames_per_request"]),
                            n_samples=int(kw["ratio_samples"]))
    return combine(b["ltc"], b["sto_direct"], b["sto_no_vis"])
