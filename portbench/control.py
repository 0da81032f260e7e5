"""The control of a cell's output check: the plain reference computed in the
precision below the renderer's (bfloat16 for its float32), put in the
renderer's place, must come out as not correct.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--device cuda]

For each seed it draws the requests and pixels as a run with that seed
does (the traffic's cameras, ``check.chosen_requests`` among the first
``requests`` requests, ``check.sampled_pixels``), renders them with the
traffic driver's reference in float32 and in bfloat16, and prints the
bfloat16 answers' ``off_pixels_pct`` beside the cell's limit, one JSON line
a seed.  It runs no code of the renderer; the benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control(workload: str, seed: int, device: str, requests: int = 16, overrides: dict | None = None) -> dict:
    import torch

    from portbench.harness import check, traffic
    from portbench.harness.cell import _merge
    from portbench.harness.manifest import CACHE_DIR, cell_spec, scene_json
    from portbench.reference.render import RefScene
    from portbench.reference.scene import load_scene

    t0 = time.perf_counter()
    spec = _merge(cell_spec(workload), overrides)
    cfg, tr, chk = spec["config"], spec["traffic"], spec["check"]
    driver = traffic.load_driver(tr["driver"])
    tables = load_scene(scene_json(cfg), CACHE_DIR)
    ref32, low = RefScene(tables, device, torch.float32), RefScene(tables, device, torch.bfloat16)
    base = tables["cameras"][0]
    cams = list(itertools.islice(driver.cameras(tr, base, seed), requests))
    pixels = check.sampled_pixels(cfg["width"], cfg["height"], int(chk["pixels"]), seed)
    worst = 0.0
    for i in check.chosen_requests(len(cams), int(chk["requests"]), seed):
        want = driver.reference(ref32, tr, cams[i], cfg["width"], cfg["height"], pixels)
        got = driver.reference(low, tr, cams[i], cfg["width"], cfg["height"], pixels)
        worst = max(worst, check.off_share(got, want, float(chk["rel_tol"])))
    return {"workload": workload, "seed": seed, "dtype": "bfloat16", "off_pixels_pct": worst,
            "limit": float(chk["limit_pct"]), "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
