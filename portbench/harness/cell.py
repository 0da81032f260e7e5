"""One run of one cell: set-up, the measured window, the reading of the
trace, the output check, and the result line's object.

Set-up builds the Renderer on the configuration's scene (OBJ parse, trace
tables loaded from or stored into ``portbench/cache/bvh/``) and warms the
cell's own key with the traffic driver's ``warm``: the key's eager frame,
then the frame graph's capture, ``set_camera`` and the readback.  Nothing
else is warmed.  The window then
serves the traffic's requests for ``seconds``; with ``trace`` its first
requests (at least ``TRACE_SECONDS``) run under the profiler.  After the
window the peak memory is read, the renderer is freed, and the plain
reference renders the check's sample.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

from . import check as checklib
from . import traffic as trafficlib
from .manifest import CACHE_DIR, cell_spec, metric_reader, scene_json

TRACE_SECONDS = 1.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optix_renderer_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _merge(spec: dict, overrides: dict | None) -> dict:
    for part, values in (overrides or {}).items():
        spec[part] = {**spec[part], **values}
    return spec


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", overrides: dict | None = None, log=print) -> dict:
    """The run's result object; ``overrides`` ({"config" | "traffic" |
    "check": {key: value}}) shrink a cell for a test on the CPU."""
    import torch

    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene.config import parse_scene

    spec = _merge(cell_spec(workload), overrides)
    cfg, traffic, chk = spec["config"], spec["traffic"], spec["check"]
    driver = trafficlib.load_driver(traffic["driver"])
    path = scene_json(cfg)
    with open(path) as f:
        c0 = json.load(f)["cameras"][0]
    base_cam = (np.asarray(c0["from"], np.float32), np.asarray(c0["to"], np.float32),
                np.asarray(c0["up"], np.float32), float(c0["cos_fovy"]))
    width, height = int(cfg["width"]), int(cfg["height"])
    kw = dict(traffic["renderer"])
    mode = RendererType[kw.pop("mode")]
    r = Renderer(parse_scene(path), width=width, height=height, mode=mode, device=device,
                 bvh_cache_dir=os.path.join(CACHE_DIR, "bvh"), **kw)
    pixels = checklib.sampled_pixels(width, height, int(chk["pixels"]), seed)
    driver.warm(r, traffic, base_cam, pixels)
    cuda = r.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(r.device)
    rays0 = r.metrics["rays_traced"]
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        from .trace import Tracer

        tracer = Tracer(r, TRACE_SECONDS)
    reqs, window_s = trafficlib.window(r, traffic, driver, base_cam, seed, seconds, pixels, tracer=tracer)
    if cuda:
        torch.cuda.synchronize(r.device)
    peak = int(torch.cuda.max_memory_allocated(r.device)) if cuda else 0
    frames = sum(q.frames for q in reqs)
    rays = r.metrics["rays_traced"] - rays0
    log(f"portbench: {workload} seed {seed}: {len(reqs)} requests, {frames} frames, {rays} honest rays "
        f"traced in {window_s:.6f} s ({rays / window_s / 1e6:.3f} honest Mrays/s)")
    record = {
        "workload": workload, "width": width, "height": height, "triangles": int(r.bvh.num_tris),
        "lights": int(r.device_scene.num_lights),
        "setup_s": setup_s, "window_s": window_s, "frames": frames, "requests": len(reqs),
        "latencies_ms": [1e3 * (q.t1 - q.t0) for q in reqs], "peak_bytes": peak, "honest_rays": rays,
        "trace": tracer.record() if tracer is not None else None,
    }
    kind = torch.cuda.get_device_name(r.device) if cuda else "cpu"
    failed = sum(q.frames for q in reqs if not np.isfinite(q.sample).all())
    del r, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = checklib.compare(reqs, spec, driver, pixels, seed, device)
    log(f"portbench: checked requests {result['checked']} in {result['reference_s']:.3f} s")
    checks = {"off_pixels_pct": {"value": result["off_pixels_pct"], "limit": float(chk["limit_pct"])}}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in names:
        value = metric_reader(m["name"]).read(record) if (not trace or record["trace"]) else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": frames, "failed": failed, "metrics": metrics, "device": dev}
    if trace and record["trace"]:
        from .trace import breakdown

        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        out["breakdown"] = breakdown(record["trace"])
    out["checks"] = checks
    return out
