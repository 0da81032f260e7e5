"""Whether what the timed path produced is correct: a sample of the
window's requests, drawn from the seed, each compared on the run's
sampled pixels with the plain reference (``portbench/reference``),
computed once the renderer is gone, by the traffic driver's
``reference``.

A pixel is off when its largest channel error exceeds ``rel_tol`` of the
reference value's largest channel, or of a floor of 1 % of the sample's
mean value for dark pixels.  The number compared is ``off_pixels_pct``:
the share of off pixels in the worst request checked, in percent, against
the cell's limit (``portbench/checks/<workload>.json``).
"""

from __future__ import annotations

import time

import numpy as np

from .manifest import CACHE_DIR, scene_json

_DARK = 0.01


def sampled_pixels(width: int, height: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 1])
    return np.sort(rng.choice(width * height, size=min(n, width * height), replace=False))


def chosen_requests(n_requests: int, k: int, seed: int) -> list[int]:
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 2])
    return sorted(int(i) for i in rng.choice(n_requests, size=min(k, n_requests), replace=False))


def off_share(prog: np.ndarray, ref: np.ndarray, rel_tol: float) -> float:
    """Share of pixels (rows of (P, 3)) whose value is off, in percent;
    a non-finite value is off."""
    mag = np.abs(ref).max(axis=1)
    floor = _DARK * max(float(mag.mean()), 1e-30)
    err = np.abs(prog - ref).max(axis=1) / np.maximum(mag, floor)
    off = ~(err <= rel_tol)
    return 100.0 * float(off.mean())


def reference_scene(spec: dict, device, dtype):
    """The cell's scene for the plain reference, parsed from its files."""
    from ..reference.render import RefScene
    from ..reference.scene import load_scene

    return RefScene(load_scene(scene_json(spec["config"]), CACHE_DIR), device, dtype)


def compare(reqs, spec: dict, driver, pixels: np.ndarray, seed: int, device) -> dict:
    """{"off_pixels_pct": worst request's share, "checked": indices,
    "reference_s": seconds}, the reference in float32."""
    import torch

    t0 = time.perf_counter()
    cfg, check = spec["config"], spec["check"]
    scene = reference_scene(spec, device, torch.float32)
    idx = chosen_requests(len(reqs), int(check["requests"]), seed)
    worst = 0.0
    for i in idx:
        ref = driver.reference(scene, spec["traffic"], reqs[i].camera, cfg["width"], cfg["height"], pixels)
        worst = max(worst, off_share(reqs[i].sample, ref, float(check["rel_tol"])))
    return {"off_pixels_pct": worst, "checked": idx, "reference_s": time.perf_counter() - t0}
