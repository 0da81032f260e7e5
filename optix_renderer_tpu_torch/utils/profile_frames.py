"""Where a frame's device time goes, on one CUDA card.

    python -m optix_renderer_tpu_torch.utils.profile_frames --config 5 6 5b path ltc ratio cap [--frames 2]
        [--plain] [--out prof.jsonl]

Configs (``benchmarks/RESULTS.json``): ``5`` terrain NORMALS at 1024^2
(999,710 triangles, grid 708), ``5b`` the same terrain in PATH depth 4,
``6`` the gallery in PATH depth 4 at 512^2; and the brute tier's main
paths at 1024^2: ``path`` (PATH depth 4 on Cornell), ``ltc``
(LTC_BASELINE on Cornell), ``ratio`` (RATIO with 4 shadow samples on the
three-light Cornell), and ``cap`` (PATH depth 4 on the terrain at grid
46: 4,062 triangles, the largest in the brute tier).  For each config, after one warm-up
frame the script times ``--frames`` frames on the host clock (each ends
in ``torch.cuda.synchronize()``), then renders as many again under
``torch.profiler``, timing those on the host clock too.  The stages:

* ``B1``, ``B2`` (brute tier), ``B3``, ``B4`` (list form), ``B3_baked``
  (the baked walk of the primaries), ``B3_walk``, ``B4_walk`` (walk form),
  ``B5``, ``B6`` (LTC), ``K1``, ``K2`` (the path bounce before and after
  its traces), ``K3`` (the brute tier's shading): the hand-written
  kernels, found by their names in the device trace (the first stage
  whose name matches);
* ``sweep``: the per-ray supercluster sweep (t bounds, corridor keys);
* ``sort``: ``torch.argsort`` (the coherence sort, fallback batching);
* ``cull``: the first pass's tile-frustum culls (and the per-lane culls of
  a list-form per-lane trace, which rays on the card no longer take);
* ``fallback_cull``: the checked fallback's single-level re-culls;
* ``camera_rng``: the primary rays (pixel order, camera) and every LCG
  seed and draw (``core.rng.make_rng``, ``lcg_randomf``);
* ``shade``: the fused surface interaction from B5's columns, and the
  brute tier's plain shade gather (``build_surface_interaction``);
* ``nee``, ``bsdf``, ``combine``: the plain path bounce
  (``integrators.path_kernel``): the light sample and NEE, the shading
  frame with the BSDF sample and evaluation, and the MIS weights,
  throughput and accumulation after the traces (in a kernel frame these
  are K1 and K2);
* ``ltc``: the LTC term (``integrators.ltc_direct.ltc_direct``) outside
  B6, that is its setup: 0 where B6 takes the hits themselves;
* ``glue``: all other device time (integrator, camera, accumulation).

The PyTorch stages are wrapped in a ``record_function`` range once, at
the start, for every run (the library itself carries no profiling code);
such a range shows up on the device as a span over the kernels its ops
launched, and a kernel belongs to the span that holds it.  A stage called
inside another stage's range opens none of its own (the bounce's LCG
draws inside K1's plain version are ``camera_rng`` because that version's
draws sit outside its ``nee`` and ``bsdf`` pieces), so no range holds
another.  (The
profiler's link from a kernel to its launching op is not used: it can
attach one kernel to two host events.)

Prints one JSON line per config: the card (``nvidia-smi`` name and
power limit), wall ms/frame unprofiled and profiled, device kernel
ms/frame of the profiled frames, their idle share ``1 - device /
profiled wall`` (the profiler's own host cost per launch makes it an
upper bound for an unprofiled frame), kernels per frame, per stage the
device ms and calls per frame, and the ten kernels that take the most
device time.
A deterministic mode (NORMALS, LTC_BASELINE) renders one frame per
accumulation, so ``set_camera`` comes before each of its frames.
``--plain``: the eager frames take the plain versions of K1-K3 on the card
(``_frame_impl(..., plain=True)``), the glue as it ran before those
kernels, split into the stages above; the replays still launch them.

The line also holds ``render_n``: the same numbers for the frames the
Renderer really renders, ``--frames`` replays of its frame graph
(``engine.frame_graph``; captured in a warm-up before): one
``render(--frames)`` call in PATH and RATIO, ``--frames`` times
``set_camera`` and ``render(1)`` in a deterministic mode.  The PyTorch
stage ranges do not appear inside a replay, so there the stages' kernels
count as glue; the hand-written kernels still count by name.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

CONFIGS = {  # name: (scene, mode, resolution, path depth)
    "5": ("terrain", "NORMALS", 1024, 4),
    "5b": ("terrain", "PATH", 1024, 4),
    "6": ("gallery", "PATH", 512, 4),
    "path": ("cornell", "PATH", 1024, 4),
    "ltc": ("cornell", "LTC_BASELINE", 1024, 4),
    "ratio": ("cornell3", "RATIO", 1024, 4),
    "cap": ("terrain_cap", "PATH", 1024, 4),
}
# 2 * (grid - 1)^2 heightfield triangles + the 12 of the Cornell walls: 999,710 and 4,062
TERRAIN_GRIDS = {"terrain": 708, "terrain_cap": 46}
STAGES = ("sweep", "sort", "cull", "fallback_cull", "shade", "ltc",  # record_function ranges
          "camera_rng", "nee", "bsdf", "combine")
# the hand-written kernels' names in csrc/brute_trace.cu, csrc/cluster_trace.cu, csrc/ltc.cu,
# csrc/path_bounce.cu and csrc/brute_shade.cu, the first match decides (the baked walk is
# closest_walk_kernel over BakedTri rows)
KERNEL_STAGES = {"B1": "closest_kernel", "B2": "any_kernel", "B3": "closest_cluster_kernel",
                 "B4": "any_cluster_kernel", "B3_baked": "BakedTri", "B3_walk": "closest_walk_kernel",
                 "B4_walk": "any_walk_kernel", "B5": "winner_attr_kernel", "B6": "ltc_kernel",
                 "K1": "path_sample_kernel", "K2": "path_combine_kernel", "K3": "brute_shade_kernel"}
TOP_KERNELS = 10


_open = threading.local()  # .depth: stage ranges open on this thread


def labeled(fn, label):
    """``fn`` inside a profiler range named ``label`` (or ``label(kwargs)``),
    unless it runs inside another such range."""

    def wrapper(*args, **kwargs):
        depth = getattr(_open, "depth", 0)
        if depth:
            return fn(*args, **kwargs)
        name = label(kwargs) if callable(label) else label
        _open.depth = 1
        try:
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        finally:
            _open.depth = 0

    return wrapper


def _instrument() -> None:
    """Wrap each PyTorch stage's entry point in a named profiler range."""
    from ..accel import cluster
    from ..core import rng
    from ..engine import camera, renderer, shade
    from ..integrators import ltc_direct, path_kernel, ratio

    for name in ("ray_t_bounds", "corridor_keys_and_t_bounds"):
        setattr(cluster, name, labeled(getattr(cluster, name), "sweep"))
    for name in ("cull_clusters", "cull_clusters_per_lane"):
        setattr(cluster, name, labeled(getattr(cluster, name),
                                        lambda kw: "fallback_cull" if kw.get("single_level") else "cull"))
    torch.argsort = labeled(torch.argsort, "sort")
    shade.build_surface_interaction_fused = labeled(shade.build_surface_interaction_fused, "shade")
    shade.build_surface_interaction = labeled(shade.build_surface_interaction, "shade")
    for mod, name in ((rng, "make_rng"), (rng, "lcg_randomf"), (camera, "primary_rays"), (renderer, "pixel_order")):
        setattr(mod, name, labeled(getattr(mod, name), "camera_rng"))
    path_kernel._nee_plain = labeled(path_kernel._nee_plain, "nee")
    path_kernel._local_frame = labeled(path_kernel._local_frame, "bsdf")
    path_kernel._bsdf_plain = labeled(path_kernel._bsdf_plain, "bsdf")
    path_kernel.path_combine_plain = labeled(path_kernel.path_combine_plain, "combine")
    ltc_direct.ltc_direct = ratio.ltc_direct = labeled(ltc_direct.ltc_direct, "ltc")  # ratio holds its own name


def _eager_frames(r, n: int, plain: bool) -> None:
    """n ``_frame_impl`` frames from ``r.state``, op by op; r is left as it was."""
    from ..engine.renderer import _frame_impl

    state = r.state
    for _ in range(n):
        state = _frame_impl(state, r.device_scene, r.bvh, mode=r.mode, width=r.width, height=r.height,
                            path_depth=r.path_depth, ratio_samples=r.ratio_samples, baked_tab=r.baked_tab,
                            plain=plain)[0]
    torch.cuda.synchronize()


def _replayed_frames(r, n: int, deterministic: bool) -> None:
    """n frames as the Renderer renders them: replays of its frame graph."""
    if not deterministic:
        r.render(n)
        return
    for _ in range(n):
        r.set_camera(r.scene.cameras[0])  # one frame per accumulation
        r.render(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--plain", action="store_true",
                    help="eager frames through the plain versions of K1-K3 (the glue before those kernels)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frames: torch.cuda.is_available() is false; it needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _instrument()
    lines = [json.dumps(profile_config(config, args.frames, smi, args.plain)) for config in args.config]
    for line in lines:
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def profile_config(config: str, frames: int, smi: str, plain: bool = False) -> dict:
    from ..engine.modes import DETERMINISTIC_MODES, RendererType
    from ..engine.renderer import Renderer
    from ..scene import parse_scene, write_terrain_scene

    scene_name, mode, res, depth = CONFIGS[config]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        if scene_name in TERRAIN_GRIDS:
            scene = parse_scene(write_terrain_scene(tmp, grid=TERRAIN_GRIDS[scene_name], width=res, height=res))
        else:
            scene = parse_scene(os.path.join(root, "scenes", scene_name, "scene.json"))
        r = Renderer(scene, width=res, height=res, mode=RendererType[mode], path_depth=depth, device="cuda")
    deterministic = r.mode in DETERMINISTIC_MODES
    _eager_frames(r, 1, plain)  # warm-up
    single = _measure(lambda: _eager_frames(r, frames, plain), frames)
    _replayed_frames(r, 2, deterministic)  # the key's eager frame, then the frame graph's capture and a replay
    render_n = {"note": f"{frames} replays of the frame graph ("
                        + ("set_camera and render(1) each" if deterministic else f"render({frames})")
                        + "); stage ranges do not appear inside a replay (their kernels count as glue there), "
                          "hand-written kernels count by name",
                **_measure(lambda: _replayed_frames(r, frames, deterministic), frames)}
    m = r.metrics
    return {
        "config": config, "scene": scene_name, "mode": mode, "res": res, "path_depth": depth,
        "triangles": r.bvh.num_tris, "clusters": r.bvh.num_clusters, "frames": frames, "plain_eager": plain,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **single, "render_n": render_n,
        # summed over the warm-up, timed and profiled frames
        "cull_stats": {k: m[k] for k in ("cull_overflow", "cull_retraces", "cull_unresolved_tiles")},
    }


def _measure(run, frames: int) -> dict:
    """``run()`` (``frames`` frames, ending in a synchronize) on the host
    clock, then again under the profiler: wall ms per frame of both, the
    idle share and the device breakdown of the profiled run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    breakdown = device_breakdown(prof.events(), frames)
    return {"wall_ms_per_frame": wall_ms, "profiled_wall_ms_per_frame": prof_wall_ms,
            "idle_share": 1.0 - breakdown["device_ms_per_frame"] / prof_wall_ms, **breakdown}


def device_breakdown(events, frames: int) -> dict:
    """Device time per frame of a profiled run (``prof.events()``): in
    total, per stage, the rest as glue, and the largest kernels by name.
    The hand-written kernels count by name (``KERNEL_STAGES``); every other
    kernel belongs to the ``STAGES`` range whose device-side span holds it
    (one stream runs its kernels one after another, and no stage range
    holds another).  Every kernel counts once."""
    host = torch.autograd.DeviceType.CPU
    on_device = sorted((e for e in events if e.device_type != host), key=lambda e: e.time_range.start)
    spans = [e for e in on_device if e.name in STAGES]  # a stage range's span on the device
    kernels = [e for e in on_device if e.name not in STAGES]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / frames
    stages = {name: {"device_ms_per_frame": 0.0, "calls_per_frame": 0.0} for name in (*KERNEL_STAGES, *STAGES)}
    for e in events:
        if e.device_type == host and e.name in STAGES:
            stages[e.name]["calls_per_frame"] += 1 / frames
    owner: list = [None] * len(kernels)
    for i, e in enumerate(kernels):
        label = next((label for label, kname in KERNEL_STAGES.items() if kname in e.name), None)
        if label is not None:
            owner[i] = label
            stages[label]["calls_per_frame"] += 1 / frames
    starts = [e.time_range.start for e in kernels]
    for span in spans:
        i = bisect.bisect_left(starts, span.time_range.start)
        while i < len(kernels) and kernels[i].time_range.end <= span.time_range.end:
            owner[i] = owner[i] or span.name
            i += 1
    by_name: dict = {}
    for e, label in zip(kernels, owner):
        ms = e.time_range.elapsed_us() / 1e3 / frames
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
        if label is not None:
            stages[label]["device_ms_per_frame"] += ms
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS])
    glue = device_ms - sum(s["device_ms_per_frame"] for s in stages.values())
    return {"device_ms_per_frame": device_ms, "kernels_per_frame": len(kernels) / frames,
            "stages": stages, "glue_ms_per_frame": glue, "top_kernels_ms_per_frame": top}


if __name__ == "__main__":
    sys.exit(main())
