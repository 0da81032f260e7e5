"""Where a frame's device time goes, on one CUDA card.

    python -m optix_renderer_tpu_torch.utils.profile_frames --config 5 6 5b path ltc ratio cap tetra tetra3
        [--frames 2] [--plain] [--out prof.jsonl]

Configs (``benchmarks/RESULTS.json``): ``5`` terrain NORMALS at 1024^2
(999,710 triangles, grid 708), ``5b`` the same terrain in PATH depth 4,
``6`` the gallery in PATH depth 4 at 512^2, ``tetra`` SPD's tetra
(``scene.procedural.write_spd_tetra_scene``, 1,048,576 triangles) in PATH
depth 4 at 1024^2, ``tetra3`` the same tetra under three area lights
(the benchmark's ``portbench/scenes/spd-tetra-3lights/``) in RATIO with 4
shadow samples at 1024^2; and the brute tier's main
paths at 1024^2: ``path`` (PATH depth 4 on Cornell), ``ltc``
(LTC_BASELINE on Cornell), ``ratio`` (RATIO with 4 shadow samples on the
three-light Cornell), and ``cap`` (PATH depth 4 on the terrain at grid
46: 4,062 triangles, the largest in the brute tier).  For each config, after one warm-up
frame the script times ``--frames`` frames on the host clock (each ends
in ``torch.cuda.synchronize()``), then renders as many again under
``torch.profiler``, timing those on the host clock too.  The stages:

* ``B1``, ``B2`` (brute tier), ``B3_baked`` (the baked walk of the
  primaries), ``B3_walk``, ``B4_walk`` (the cluster tier's walks),
  ``B6`` (LTC), ``K0`` (the camera and RNG head), ``K1``, ``K2``
  (the path bounce before and after its traces), ``K3`` (the brute tier's
  shading), ``K4`` (the cluster tier's shading, the winners' rows
  included), ``S`` (K-sweep, the cluster tier's supercluster sweep): the
  hand-written kernels, found by their names in the device trace (the
  first stage whose name matches);
* ``sweep``: the PyTorch operations of the per-ray supercluster sweep (t
  bounds, corridor keys; span ``trace.sweep``): on the card, where K-sweep
  does the sweep, at most a t_max's conversion;
* ``sort``: the coherence sort (``trace.sort``);
* ``camera_rng``: the primary rays in plain PyTorch (pixel order, the
  RNG's seeds and jitter draws, the camera; ``frame.camera_rng``: in a
  kernel frame K0);
* ``shade``: the plain shadings of both tiers, outside K3 and K4
  (``trace.shade``);
* ``nee``, ``bsdf``, ``combine``: the plain path bounce
  (``integrators.path_kernel``): the light sample and NEE
  (``bounce.nee``), the shading frame with the BSDF sample and evaluation
  (``bounce.bsdf``), and what follows the traces (``frame.bounce.combine``:
  in a kernel frame K2);
* ``ltc``: the LTC term (``integrators.ltc_direct.ltc_direct``,
  ``ltc.direct``) outside B6, that is its setup: 0 where B6 takes the
  hits themselves;
* ``glue``: all other device time (integrator, accumulation, the bounce's
  own draws and counts).

A stage is the program's own span (``utils.launches.span``, a profiler
range while the profiler is open): an eager kernel belongs to the
innermost stage span around its launch on the host (the CUDA call of its
correlation id), so a span inside another wins.  A replayed frame runs no
Python; its kernels take the stage of their position in the replay from
the frame graph's stage map (``FrameGraph.stages``, recorded at the
capture): the ``frame.*`` stage, and inside it the cluster tier's
``trace.*`` stage where there is one, which wins.

Prints one JSON line per config: the card (``nvidia-smi`` name and
power limit), wall ms/frame unprofiled and profiled, device kernel
ms/frame of the profiled frames, their idle share ``1 - device /
profiled wall`` (the profiler's own host cost per launch makes it an
upper bound for an unprofiled frame), kernels per frame, per stage the
device ms and calls per frame, and the ten kernels that take the most
device time.
A deterministic mode (NORMALS, LTC_BASELINE) renders one frame per
accumulation, so ``set_camera`` comes before each of its frames.
``--plain``: the eager frames take the plain versions of K0-K4 on the card
(``_frame_impl(..., plain=True)``), the glue as it ran before those
kernels, split into the stages above; the replays still launch them.

The line also holds ``render_n``: the same numbers for the frames the
Renderer really renders, ``--frames`` replays of its frame graph
(``engine.frame_graph``; captured in a warm-up before): one
``render(--frames)`` call in PATH and RATIO, ``--frames`` times
``set_camera`` and ``render(1)`` in a deterministic mode.  Every line
holds ``frame_stages``, the device ms a frame of every operation by the
innermost program span (eager) or the stage map's ``frame.*`` stage
(replayed) that made it, ``glue_stages``, the same for the operations
that are not hand-written kernels, ``unmapped_replays``, the replays whose
operations did not match the stage map (their stages are then unknown),
and the card's idle ms a frame inside the ``renderer.render`` spans:
``replay_gap_ms_per_frame`` between one graph replay and the next,
``call_gap_ms_per_frame`` the rest, the call's own host work.

In RATIO the line holds ``ratio_shadow_rays``: the rays of a frame's
visibility batch and those of them from lanes that hit a non-emitting
surface (``Renderer.metrics``' ``ratio_live_shadow_rays``), which are the
rays traced: the others' t bound is +0, and no kernel tests them.  On the cluster tier
the line also holds ``walk_work``: the walk kernels'
own counters (``csrc/cluster_trace.cu``'s ``add_work``) over the launches
of B3-baked, B3 and B4 in one eager frame after the timed and profiled
frames (``utils.launches.work_records``): slab tests, ray/triangle tests
and the lane slots spent on each, per live ray (t bound above 0), beside
``cluster_trace.walk_bound_counts``, the least any walk to the same final
bounds needs, and ``cluster_area_ratio``: the summed surface area of the
cluster boxes, and of the supercluster boxes, over the scene box's (how
tight the tables the walks read are; the build's order decides it).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from . import launches

CONFIGS = {  # name: (scene, mode, resolution, path depth)
    "5": ("terrain", "NORMALS", 1024, 4),
    "5b": ("terrain", "PATH", 1024, 4),
    "6": ("gallery", "PATH", 512, 4),
    "path": ("cornell", "PATH", 1024, 4),
    "ltc": ("cornell", "LTC_BASELINE", 1024, 4),
    "ratio": ("cornell3", "RATIO", 1024, 4),
    "cap": ("terrain_cap", "PATH", 1024, 4),
    "tetra": ("spd_tetra", "PATH", 1024, 4),
    "tetra3": ("spd_tetra3", "RATIO", 1024, 4),
}
# 2 * (grid - 1)^2 heightfield triangles + the 12 of the Cornell walls: 999,710 and 4,062
TERRAIN_GRIDS = {"terrain": 708, "terrain_cap": 46}
# the program's spans (utils.launches.span) each stage reads
SPAN_STAGES = {"trace.sweep": "sweep", "trace.sort": "sort", "trace.shade": "shade", "ltc.direct": "ltc",
               "frame.camera_rng": "camera_rng", "bounce.nee": "nee", "bounce.bsdf": "bsdf",
               "frame.bounce.combine": "combine"}
STAGES = tuple(SPAN_STAGES.values())
# the hand-written kernels' names in csrc/brute_trace.cu, csrc/cluster_trace.cu, csrc/ltc.cu,
# csrc/camera_rng.cu, csrc/path_bounce.cu, csrc/brute_shade.cu, csrc/cluster_shade.cu and csrc/sc_sweep.cu, the
# first match decides (the baked walk is closest_walk_kernel over BakedTri rows)
KERNEL_STAGES = {"B1": "closest_kernel", "B2": "any_kernel", "B3_baked": "BakedTri", "B3_walk": "closest_walk_kernel",
                 "B4_walk": "any_walk_kernel", "B6": "ltc_kernel",
                 "K0": "camera_rng_kernel", "K1": "path_sample_kernel", "K2": "path_combine_kernel",
                 "K3": "brute_shade_kernel", "K4": "cluster_shade_kernel", "S": "supercluster_sweep_kernel"}
TOP_KERNELS = 10


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
                    help="eager frames through the plain versions of K0-K4 (the glue before those kernels)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frames: torch.cuda.is_available() is false; it needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lines = [json.dumps(profile_config(config, args.frames, smi, args.plain)) for config in args.config]
    for line in lines:
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def profile_config(config: str, frames: int, smi: str, plain: bool = False) -> dict:
    from ..accel.build import cluster_area_ratio
    from ..engine.modes import DETERMINISTIC_MODES, RendererType
    from ..engine.renderer import Renderer
    from ..scene import parse_scene, write_spd_tetra_scene, write_terrain_scene

    scene_name, mode, res, depth = CONFIGS[config]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        if scene_name in TERRAIN_GRIDS:
            scene = parse_scene(write_terrain_scene(tmp, grid=TERRAIN_GRIDS[scene_name], width=res, height=res))
        elif scene_name == "spd_tetra":
            scene = parse_scene(write_spd_tetra_scene(tmp))
        elif scene_name == "spd_tetra3":
            scene = parse_scene(os.path.join(root, "portbench", "scenes", "spd-tetra-3lights", "scene.json"))
        else:
            scene = parse_scene(os.path.join(root, "scenes", scene_name, "scene.json"))
        r = Renderer(scene, width=res, height=res, mode=RendererType[mode], path_depth=depth, device="cuda")
    deterministic = r.mode in DETERMINISTIC_MODES
    _eager_frames(r, 1, plain)  # warm-up
    single = _measure(lambda: _eager_frames(r, frames, plain), frames)
    _replayed_frames(r, 2, deterministic)  # the key's eager frame, then the frame graph's capture and a replay
    render_n = {"note": f"{frames} replays of the frame graph ("
                        + ("set_camera and render(1) each" if deterministic else f"render({frames})")
                        + "); replayed kernels take their stage from the frame graph's stage map, "
                          "hand-written kernels count by name",
                **_measure(lambda: _replayed_frames(r, frames, deterministic), frames, r.frame_stages())}
    line = {
        "config": config, "scene": scene_name, "mode": mode, "res": res, "path_depth": depth,
        "triangles": r.bvh.num_tris, "clusters": r.bvh.num_clusters, "frames": frames, "plain_eager": plain,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **single, "render_n": render_n,
    }
    if r.bvh.clustered:
        line["walk_work"] = walk_work(r)
        line["cluster_area_ratio"] = dict(zip(("clusters", "superclusters"), cluster_area_ratio(r.bvh)))
    if r.mode == RendererType.RATIO:
        line["ratio_shadow_rays"] = ratio_shadow_rays(r.metrics)
    return line


def ratio_shadow_rays(metrics: dict) -> dict:
    """RATIO's visibility rays over the frames the Renderer rendered
    (``Renderer.metrics``' counter; eager ``_frame_impl`` frames count
    nothing): the batch's rays a frame (``traced_per_frame``: every ray
    of the batch), ``live_per_frame`` (those of lanes that hit a
    non-emitting surface, the rays the kernels test), and the live share,
    the share of the batch traced."""
    frames = metrics["frames"]
    live, traced = metrics["ratio_live_shadow_rays"], metrics["ratio_shadow_rays"]
    return {"frames": frames, "traced_per_frame": traced / frames, "live_per_frame": live / frames,
            "live_share": live / traced}


# the walk kernels' labels by their launch names (``cluster_trace.LAUNCHES``)
WALK_LABELS = {"cluster_closest_walk_baked": "B3_baked", "cluster_closest_walk": "B3_walk",
               "cluster_any_walk": "B4_walk"}


def walk_work(r) -> dict:
    """The walk kernels' work counters over one eager frame of ``r`` (its
    state left as it was), counted at each launch of B3-baked, B3 and B4
    (``launches.work_records``).  Per kernel: ``launches``, ``rays``,
    ``live_rays`` (t bound above 0), and per live ray the ``slab_tests``
    and ``tri_tests`` the kernel ran, the lane slots it spent on each
    (``slab_lane_slots``, ``test_lane_slots``: 32 a warp step), and
    ``walk_bound_counts``' least ``bound_slab_tests`` and
    ``bound_tri_tests`` for the same final bounds."""
    from ..accel import cluster_trace as ct
    from ..accel.cluster import key_t_up

    with launches.work_records() as records:
        _eager_frames(r, 1, False)
    out: dict = {}
    for name, work, boxes, rays in records:
        if name == "cluster_any_walk":
            o, d, t_max, occ = rays
            live = int((t_max > 0).sum())
            bound = ct.walk_bound_counts(*boxes, o, d, t_max, occluded=occ)
        else:
            o, d, key0, key = rays
            alive = (key0 >> 6) > 0  # key0's t bits above its local id: a t bound above 0
            live = int(alive.sum())
            bound = ct.walk_bound_counts(*boxes, o, d, torch.where(alive, key_t_up(key), 0.0))
        acc = out.setdefault(WALK_LABELS[name],
                             {"launches": 0, "rays": 0, "live_rays": 0, "work": [0, 0, 0, 0], "bound": [0, 0]})
        acc["launches"] += 1
        acc["rays"] += o.shape[0]
        acc["live_rays"] += live
        acc["work"] = [a + int(w) for a, w in zip(acc["work"], work.tolist())]
        acc["bound"] = [a + int(b) for a, b in zip(acc["bound"], bound)]
    for acc in out.values():
        per = max(acc["live_rays"], 1)
        work, bound = acc.pop("work"), acc.pop("bound")
        acc.update({k: v / per for k, v in zip(("slab_tests", "tri_tests", "slab_lane_slots", "test_lane_slots"), work)})
        acc.update({"bound_slab_tests": bound[0] / per, "bound_tri_tests": bound[1] / per})
    return out


def _measure(run, frames: int, stage_map: dict | None = None) -> dict:
    """``run()`` (``frames`` frames, ending in a synchronize) on the host
    clock, then again under the profiler: wall ms per frame of both, the
    idle share and the device breakdown of the profiled run (replays by
    ``stage_map``)."""
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
    breakdown = device_breakdown(prof, frames, stage_map)
    return {"wall_ms_per_frame": wall_ms, "profiled_wall_ms_per_frame": prof_wall_ms,
            "idle_share": 1.0 - breakdown["device_ms_per_frame"] / prof_wall_ms, **breakdown}


def _named(kernel: str, op_name: str) -> bool:
    return re.search(r"(?<![A-Za-z0-9_])" + re.escape(kernel) + r"(?![A-Za-z0-9_])", op_name) is not None


def _span_chains(spans: list):
    """``chain(t, tid)``: the names of the spans open at ``t`` on thread
    ``tid``, innermost first; ``spans`` as (start, end, name, tid), which
    nest on each thread."""
    by_thread: dict = {}
    for sp in sorted(spans, key=lambda x: (x[0], -x[1])):
        by_thread.setdefault(sp[3], []).append(sp)
    parents: dict = {}
    for tid, ss in by_thread.items():
        stack, par = [], []
        for s, _e, _name, _tid in ss:
            while stack and ss[stack[-1]][1] <= s:
                stack.pop()
            par.append(stack[-1] if stack else -1)
            stack.append(len(par) - 1)
        parents[tid] = par
    starts = {tid: [sp[0] for sp in ss] for tid, ss in by_thread.items()}

    def chain(t, tid) -> list:
        ss, out = by_thread.get(tid, ()), []
        i = bisect.bisect_right(starts.get(tid, ()), t) - 1
        while i >= 0:
            if t < ss[i][1]:
                out.append(ss[i][2])
            i = parents[tid][i]
        return out

    return chain


def profiled_events(prof) -> tuple[list, dict, list]:
    """``(spans, calls, ops)`` of a profiled run (``torch.profiler.profile``
    with CPU and CUDA activity), on the profiler's one clock in ns: the
    program's spans as (start, end, name, thread), the CUDA calls as
    {correlation id: (start, name, thread)}, and the device operations
    (kernels, copies, fills) as (start, duration, name, correlation id),
    in start order."""
    host = torch.autograd.DeviceType.CPU
    spans, calls, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == host:
            if e.is_user_annotation():
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.start_thread_id()))
            elif name.startswith("cu"):  # the CUDA call that launched the operations of its correlation id
                calls[e.correlation_id()] = (e.start_ns(), name, e.start_thread_id())
        elif not e.is_user_annotation():
            ops.append((e.start_ns(), e.duration_ns(), name, e.correlation_id()))
    ops.sort()
    return spans, calls, ops


def device_breakdown(prof, frames: int, stage_map: dict | None = None) -> dict:
    """``stage_breakdown`` of a profiled run's ``profiled_events``."""
    return stage_breakdown(*profiled_events(prof), frames, stage_map)


def _render_gaps(ops: list, replay_of: list, spans: list) -> tuple[float, float]:
    """(replay gaps, call gaps) in ns: the card's idle time inside the
    ``renderer.render`` spans.  A replay gap lies between the last operation
    of one graph replay and the first of another; every other idle time
    inside a call is the call's own (its host work before, between and
    after the replays), counted where it overlaps the call's span."""
    calls = sorted((s, e) for s, e, name, _tid in spans if name == "renderer.render")
    ends = [e for _s, e in calls]

    def inside(a, b):  # the part of (a, b) that the calls' spans cover (they do not overlap)
        covered, i = 0, bisect.bisect_right(ends, a)
        while i < len(calls) and calls[i][0] < b:
            covered += min(b, calls[i][1]) - max(a, calls[i][0])
            i += 1
        return covered

    replay_ns = call_ns = 0
    end = last = None  # the end of the card's busy time so far, and the replay of the operation that ends it
    for (s, d, _name, _corr), replay in zip(ops, replay_of):
        if end is not None and s > end:
            idle = inside(end, s)
            if last is not None and replay is not None and last != replay:
                replay_ns += idle
            else:
                call_ns += idle
        if end is None or s + d > end:
            end, last = s + d, replay
    return replay_ns, call_ns


def stage_breakdown(spans: list, calls: dict, ops: list, frames: int, stage_map: dict | None = None) -> dict:
    """Device time per frame of a profiled run, from its
    ``profiled_events``: in total, per stage, the rest as glue, the largest
    kernels by name, per program span (``frame_stages``, and
    ``glue_stages`` for the operations that are not hand-written kernels),
    and the card's idle time inside the ``renderer.render`` spans split
    into the gaps between graph replays and the call's own
    (``replay_gap_ms_per_frame``, ``call_gap_ms_per_frame``).  The
    hand-written kernels count by name (``KERNEL_STAGES``).  Every other
    operation takes, if it was launched eagerly, the spans open around its
    launch (innermost first), or, if a graph replay ran it (the operations
    of one graph launch share its correlation id), the ``frame.*`` stage of
    its position in the replay by ``stage_map`` (its nested ``trace.*``
    stage first, where it has one); its stage is the first of those that
    ``SPAN_STAGES`` names.  A replay whose operation count
    differs from the map's, or whose operation at a hand kernel's node is
    not that kernel, is unmapped (``unmapped_replays``): its operations
    take no span.  Every device operation counts once."""
    chain = _span_chains(spans)
    replays: dict = {}  # correlation id of a graph launch -> its operations' indices, in order
    owners: list = []  # the spans of each operation, innermost first
    replay_of: list = []  # the correlation id of each operation's graph launch, None if eager
    for i, (_s, _d, _name, corr) in enumerate(ops):
        call = calls.get(corr)
        if call is not None and "GraphLaunch" in call[1]:
            replays.setdefault(corr, []).append(i)
            owners.append([])
            replay_of.append(corr)
        else:
            owners.append(chain(call[0], call[2]) if call is not None else [])
            replay_of.append(None)
    node_stage = node_nested = []
    if stage_map:
        node_stage = [None] * stage_map["nodes"]
        node_nested = [None] * stage_map["nodes"]
        for stage, first, end in stage_map["stages"]:
            node_stage[first:end] = [stage] * (end - first)
        for stage, first, end in stage_map.get("nested", ()):
            node_nested[first:end] = [stage] * (end - first)
    unmapped = 0
    for idx in replays.values():
        if not node_stage or len(idx) != len(node_stage) or not all(
                _named(kernel, ops[idx[pos]][2]) for pos, kernel in stage_map["kernels"]):
            unmapped += 1
            continue
        for pos, i in enumerate(idx):
            owners[i] = [node_stage[pos]] if node_nested[pos] is None else [node_nested[pos], node_stage[pos]]

    stages = {name: {"device_ms_per_frame": 0.0, "calls_per_frame": 0.0} for name in (*KERNEL_STAGES, *STAGES)}
    for _s, _e, name, _tid in spans:
        if name in SPAN_STAGES:
            stages[SPAN_STAGES[name]]["calls_per_frame"] += 1 / frames
    by_name: dict = {}
    by_span: dict = {}
    glue_by_span: dict = {}
    device_ms = kernels = 0
    for (_s, d, name, _corr), owner in zip(ops, owners):
        ms = d / 1e6 / frames
        top = owner[0] if owner else None
        by_span[top] = by_span.get(top, 0.0) + ms
        kernels += 1
        device_ms += ms
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + ms
        label = next((label for label, kname in KERNEL_STAGES.items() if kname in name), None)
        if label is not None:
            stages[label]["calls_per_frame"] += 1 / frames
        else:
            glue_by_span[top] = glue_by_span.get(top, 0.0) + ms
            label = next((SPAN_STAGES[sp] for sp in owner if sp in SPAN_STAGES), None)
        if label is not None:
            stages[label]["device_ms_per_frame"] += ms
    top_kernels = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS])
    glue = device_ms - sum(st["device_ms_per_frame"] for st in stages.values())
    replay_gap, call_gap = _render_gaps(ops, replay_of, spans)
    return {"device_ms_per_frame": device_ms, "kernels_per_frame": kernels / frames,
            "stages": stages, "glue_ms_per_frame": glue, "top_kernels_ms_per_frame": top_kernels,
            "frame_stages": {str(k): v for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
            "glue_stages": {str(k): v for k, v in sorted(glue_by_span.items(), key=lambda kv: -kv[1])},
            "unmapped_replays": unmapped,
            "replay_gap_ms_per_frame": replay_gap / 1e6 / frames, "call_gap_ms_per_frame": call_gap / 1e6 / frames}


if __name__ == "__main__":
    sys.exit(main())
