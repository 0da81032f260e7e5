"""The traffic of a cell: one client in a closed loop, request after request,
as a mix file ``portbench/traffic/<mix>.json`` says.

The mix names its driver, ``portbench/traffic/<driver>.py``: the code of the
requests' cameras, of one request and of its plain reference answer.  A mix
that reuses a driver adds only its data file; a request loop of another
shape adds a driver beside the others.  Every mix has ``driver``, the
driver's name, and ``renderer``, the ``Renderer``'s keyword arguments
beside the scene, the size and the device, ``mode`` by its name
(``{"mode": "PATH", "path_depth": 4}``); the rest are the driver's
parameters.

A driver is a module with

* ``cameras(traffic, base_cam, seed)``: the requests' cameras, endless,
  each (from, to, up, cos_fovy); every seed gives the same kind of cameras
  in another order, so runs with different seeds do the same work;
* ``warm(r, traffic, base_cam, pixels)``: serve the cell's own key on
  Renderer ``r`` from cameras of its own (set-up; nothing else is
  warmed);
* ``serve(r, traffic, req, pixels, mark) -> Request``: one request; it
  sets ``t0`` and ``t1`` (host clock, the request's start and the answer in
  host memory), ``frames`` (frames accumulated) and ``sample`` (the answer
  at the run's sampled pixels), and names the host's phases with
  ``mark(name)`` (``set_camera``, ``render``, ``readback``) for a trace;
* ``reference(scene, traffic, cam, width, height, pixels)``: the plain
  reference's answer at ``pixels`` (``portbench/reference``, on a
  ``RefScene`` of any dtype).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import math
import os
import time

import numpy as np

from .manifest import BENCH_DIR


@dataclasses.dataclass
class Request:
    camera: tuple  # (from, to, up, cos_fovy)
    frames: int = 0
    t0: float = 0.0
    t1: float = 0.0
    sample: np.ndarray | None = None  # (P, 3) displayed values at the run's sampled pixels


def load_driver(name: str):
    """The driver module ``portbench/traffic/<name>.py``."""
    path = os.path.join(BENCH_DIR, "traffic", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no traffic driver {name!r} under portbench/traffic/")
    spec = importlib.util.spec_from_file_location(f"portbench_traffic_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unnamed(_name: str):
    return contextlib.nullcontext()


def orbit_camera(cam: tuple, degrees: float) -> tuple:
    """``cam`` = (from, to, up, cos_fovy) with ``from`` turned about the
    vertical axis through ``to`` by ``degrees``."""
    from_, at, up, cos_fovy = cam
    r = math.radians(degrees)
    c, s = math.cos(r), math.sin(r)
    off = np.asarray(from_, np.float64) - np.asarray(at, np.float64)
    x, z = off[0] * c + off[2] * s, -off[0] * s + off[2] * c
    new = np.asarray(at, np.float64) + np.asarray([x, off[1], z])
    return (new.astype(np.float32), np.asarray(at, np.float32), np.asarray(up, np.float32), float(cos_fovy))


def window(r, traffic: dict, driver, base_cam: tuple, seed: int, seconds: float, pixels: np.ndarray, *,
           tracer=None) -> tuple[list[Request], float]:
    """Requests one after another until ``seconds`` have passed, the last
    one finished: (requests, the window's seconds, from the first request's
    start to the last one's end).  ``tracer``: started before the first
    request and stopped at the first request boundary after its
    ``seconds``."""
    reqs: list[Request] = []
    cams = driver.cameras(traffic, base_cam, seed)
    mark = tracer.mark if tracer is not None else unnamed
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        reqs.append(driver.serve(r, traffic, Request(next(cams)), pixels, mark))
        now = time.perf_counter()
        if tracer is not None and tracer.active and now - t0 >= tracer.seconds:
            tracer.stop(reqs)
            mark = unnamed
        if now - t0 >= seconds:
            break
    if tracer is not None and tracer.active:
        tracer.stop(reqs)
    return reqs, reqs[-1].t1 - t0
