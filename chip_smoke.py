#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each printing one line or a few and its seconds (any failure
raises and exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels from ``optix_renderer_tpu_torch/csrc``,
   one nvcc per library (brute_trace, ltc, cluster_trace, camera_rng,
   path_bounce, brute_shade, cluster_shade, sc_sweep), all started together, with ptxas' register and spill
   report (B1/B2 may not spill) and B1/B2's rays a thread, chunk rows and
   shared memory a block, the SASS instructions on a lane's
   straight-line path of K1, K2, K3 and K4 (``cuobjdump -sass``,
   ``utils.brute_bench.sass_path``), and K-sweep's SASS instructions a box
   over its passes (``utils.brute_bench.sweep_box_instructions``);
3. kernels vs plain, at the main paths' shapes, timed with CUDA events in
   turns (plain, kernel, kernel, plain): B1 (closest hit) and B2
   (occlusion) on the Cornell table (1024^2 primary rays, which B1 traces
   as a coherent batch, its warps voting to leave a test none of their
   rays can pass, as the renderer launches it; 1M bounce-like rays with
   ~30 % zero t_max, traced without the vote) and at the brute tier's
   cap, the terrain
   at grid 46 (4,062 triangles, 4,064 table rows: 16 shared-memory chunks;
   every ray against the plain version, which is timed once a turn), then
   on the edges of their blocking, B1 with and without the vote (one
   ray, a ragged batch, every ray
   dead, every ray live, NaN and negative t_max, a table of 8 rows, every
   ray occluded in the first chunk), each equal to the plain version; K3
   on 1M seeded hits on the cap terrain's 4,062 triangles (its padded table at its
   largest), bit-equal on every lane, timed; |fmod(x, 1)| against
   |x - trunc(x)| (the plain version's uv wrap against K3's) on all 2^32
   float32 bit patterns on the card, equal as int32 bits (NaN as NaN); K1
   (``path_sample``), K2 (``path_combine``) and K3 (``brute_shade``), the
   path bounce around its traces and the brute tier's shading, against
   their plain versions on the inputs an eager Cornell PATH frame at 1024^2
   gave them (every bounce and every trace, recorded from the wrappers)
   and on seeded edge lanes (dead lanes, singular shading frames, grazing
   wo, light samples with a zero solid-angle pdf, black and white base
   colours at alpha 0.01 and 1, zero throughputs; occlusion and misses
   flipped; misses, light triangles and u + v = 1 hits), bit-equal on
   every lane (a differing lane is printed with its inputs), each timed in
   turns with its plain version at the frame's 1M lanes, and again as 30
   launches in one CUDA graph, replayed (``graph_ms``, the device time
   without the wrapper's host time), beside its byte bound and its issue
   floor (the straight-line SASS instructions a lane over 132 SMs x 4
   schedulers x 32 lanes an instruction a clock, at the SM clock read
   after the timed launches); K0 (``camera_rng``, the frame's camera and
   RNG head) against its plain version on five tiles (1024^2 at frame ids
   0 and 2^32 - 10000, a split tile, 1000 x 600, 30 x 17), the frame id an
   int and a 0-d tensor, bit-equal on every lane, timed in turns and as
   graph replays beside its byte bound; then one such
   frame through K0-K3 bit-equal to one through their plain versions from
   the same state, with the same per-bounce counts and honest rays; the
   crossover between the tiers: NORMALS and PATH depth 4 at 1024^2 on the
   terrain at grid 46 (brute tier) and at grid 47 (4,244 triangles,
   cluster tier), same camera, ms/frame on the host clock and the
   hand-written trace kernels' device time per frame from a profiled run
   of the same frames; B6 (LTC, from the hit: frame, LUT, matrices and
   the light loop in one launch) on the primary hits of an LTC frame at
   1024^2 on Cornell (2 triangle lights) and on the three-light Cornell
   (6), and on 1M seeded random hits with 7 lights and the edge lanes of
   ``bench_rays.random_ltc_hits`` (singular basis, head-on and
   below-horizon wo, alpha 0.01 and 1, theta near pi/2, lights facing
   away), so that every clip case occurs, against ``ltc_direct_plain``
   (tolerance of tests/unit/test_ltc_pallas.py, and at least 99.99 % of
   rays bit-equal); then, on the 1M-triangle terrain (BASELINE
   config 5), the walk of B3 on 1024^2 primaries, against its plain
   version on every ray (the key on every lane, the cluster id on 99.99 %)
   and timed in turns with it on a seeded sample of 64 tiles of 1024 rays,
   K4 (``cluster_shade``, the cluster tier's winners to the
   SurfaceInteraction) on its winners, K-sweep (the supercluster
   sweep) on the primaries (t bound) and on 1M cosine bounce rays from
   their hits and 1M NEE shadow rays, with their dead lanes moved above
   the scene (key and t bound), bit-equal to the plain sweep on every
   lane, timed in turns with it and as graph replays beside its byte bound
   and its dense issue estimate (every box tested: no floor for a kernel
   that skips groups of boxes); then the walks of B3 on the bounce rays
   and of B4 on the shadow rays, corridor-sorted as a frame sorts them,
   against their plain versions on every ray in the same way (B4 equal on
   every lane); then the baked walk (B3-baked) on the same
   primaries from the terrain Renderer's own shared-origin table, and
   again after ``set_camera`` moved the camera (a rebaked table): key and
   cid equal to the plain baked walk on every lane of the sample, the
   unbaked walk's winner on 99.9 % of all rays and, where both found the
   same triangle, the t in the keys within rtol 1e-4 / atol 1e-3
   (tests/unit/test_baked_mt.py), timed in turns with the
   unbaked walk, and the bake's own time; and both walks against
   their plain versions on a 1.28M-triangle terrain with 312
   superclusters, which takes two rounds of supercluster boxes per ray;
   K4 against its plain version (the winners' gather, then the fused
   build) on every lane of the terrain's primary winners and the winners
   of its 1M cosine bounce rays (corridor-sorted trace), and of the first
   frame's primary and bounce winners on SPD's tetra (1,048,576 triangles)
   at 1024^2 and on the textured gallery at 512^2, bit-equal, each timed
   in turns with the plain version and as graph replays beside its byte
   bounds (214 bytes a hit lane; each distinct winning row once);
   the crossover frames count one baked walk per frame on the cluster
   tier and the unbaked walk on the bounces only; then RATIO's one
   batched visibility trace at the benchmark's size: one eager RATIO frame
   at 1024^2 with 4 shadow samples on SPD's tetra under three area lights
   (``portbench/scenes/spd-tetra-3lights``), its launches counted (one
   K-sweep and one B4 for the batch), its 4,194,304 rays and t_max
   recorded as ``ratio_color`` hands them to the cluster tier, unsorted,
   and K-sweep's t bound and B4's bits from that frame bit-equal to the
   plain sweep and the plain walk on every ray; the rays of miss and light
   lanes at t_max +0 and no other change, the frame bit-equal to one that
   traces every ray, B4's work counters zero on the +0 rays, and K-sweep,
   B4 and the batch timed masked against unmasked in turns;
4. goldens: ``Renderer(device="cuda")`` on the procedural Cornell box and
   on the gallery at 64^2 against ``tests/goldens`` (g-buffers, LTC and
   the gallery's diffuse/ltc 1e-4, path 5e-3 relative RMSE; the gallery's
   primaries through the baked walk, one launch a frame), RATIO at 64^2
   over 4 frames against the port's own ``device="cpu"`` run of the same
   frames (ltc 1e-4, the stochastic buffers 5e-3), and the terrain at
   64^2 card (baked) against CPU (never baked; NORMALS 1e-4, PATH depth 4
   5e-3);
5. main path PATH: depth 4, ``scenes/cornell/scene.json`` at 1024^2,
   3 warm-up frames (under CUDA sync debugging: no frame may make the
   host wait for the card; the key's eager frame, the capture of the frame
   graph, then replays) then 16 timed frames (16 replays), with the share
   of live lanes (t_max > 0) in each B1 and B2 launch of the last frame;
6. main path LTC_BASELINE: Cornell at 1024^2, 2 warm-up frames (the
   key's eager frame, then the capture), then 16 single frames, each
   after ``set_camera`` (a deterministic mode renders one frame per
   accumulation), each a replay; in one eager ``_frame_impl`` frame,
   profiled, the LTC term must run B6 alone (no setup op), and a replayed
   frame must leave the state it started from as it was and equal it;
7. main path RATIO: the three-light Cornell at 1024^2 with 4 shadow
   samples per pixel, 3 warm-up frames under sync debugging, 16 timed
   frames, then denoise x2 and ratio-combine, checked for the invariants
   of tests/integration/test_ratio_render.py;
8. main path config 5: terrain NORMALS at 1024^2, 2 warm-up frames (the
   eager frame and the capture) under sync debugging (no sync allowed),
   then 16 single frames (replays), each after ``set_camera`` to the same
   camera (which keeps the baked table, so no bake runs inside a timed
   frame);
9. main path config 6: the gallery, PATH depth 4 at 512^2, 3 warm-up
   frames under sync debugging (no sync allowed), then 16 timed frames;
10. main path config 5b: terrain PATH depth 4 at 1024^2, 3 warm-up frames
   under sync debugging (no sync allowed), then 8 timed frames;
11. the CLI on the card, as a subprocess: the gallery in PATH at 256^2
   from a moved ``--cam-from`` with ``--save-gbuffers --save-exr
   --save-checkpoint``; the files must exist, and the checkpoint resumed
   in a Renderer built at camera 0 must rebake its table at the
   checkpoint's origin and render through the baked walk.
12. the multi-device split (``parallel.sharding``) over two shares of the
   one card, every tile a replay of its own graph (one per row range) after
   the warm-up: Cornell PATH depth 4 at 1024^2 through the row split, 4
   frames bit-equal to 4 single-device frames and to 4 ``_frame_impl``
   frames with the same honest ray count and per-bounce counts; the spp
   split's 2 frames in one step (replays of two whole-frame graphs)
   bit-equal to 2 ``_frame_impl`` frames; config 5's terrain NORMALS at
   1024^2 through the row split, every tile's primaries through the baked
   walk (one launch a tile), bit-equal to the single frame and to the
   eager frame; no implicit sync in a split frame; ms/frame of split and
   single;
13. the live viewer (``engine.serve.ViewerServer`` on port 0) over config
   5b, terrain PATH depth 4 at 1024^2: three rounds of 10 /status requests
   and an orbit while a frame is in flight (the render thread is held
   just after it enqueued that frame until the round's client process has
   had its answers, so the orbit races the frame whatever the host's
   timing), each round from a client process of its own (as a browser,
   ready before it asks: its URL opener built, the address resolved),
   every answer under a third of
   the median committed frame; after each orbit /status reads accum_id 0,
   the next committed frame is accum_id 1, the baked table's origin is the
   new camera's, a frame in flight was dropped and the frame graph was not
   captured again (its capture, on the render thread, is timed); NORMALS
   and LTC_BASELINE stop at one frame, LTC_BASELINE launches B6; back to
   PATH; a screenshot, a recorded camera, /frame.png's latency, a finite
   image;
14. the BVH cache on the terrain: a cold build and a warm load into a
   temporary directory, every tensor equal, their host seconds; the CLI
   as a subprocess with ``--bvh-cache`` twice, the second run loading the
   entry the first wrote;
15. one dispatch for every frame (``engine.frame_graph``): LTC_BASELINE on
   Cornell (config 1) and config 5's NORMALS, one frame per accumulation
   (16 of them), ``render(8)`` on Cornell PATH depth 4, RATIO on the
   three-light Cornell and config 6, ``render(3)`` on config 5b: from one
   state, ``_frame_impl`` frames run directly against the Renderer's
   frames (replays of the graph captured in the warm-up): the
   accumulator, the last frame's g-buffers and the aux bit-equal, the same
   honest rays and per-bounce counts, the same launch counts, no implicit
   sync; then eager frames against replays in turns (host clock and CUDA
   events), the capture's ms, and the peak memory both ways (the graph's
   one pool, what dropping the graph gives back, beside it); a detached
   frame (``render_step_detached``) on a side stream, bit-equal to the
   eager frame and leaving the renderer as it was; and, on config 6,
   ``render(3)``, a detached frame on a side stream, ``commit_step``, a
   rebaking ``set_camera`` and ``render(3)``, bit-equal to the same frames
   run eagerly, with no capture after the first.  Every capture of the run
   is timed (host clock, synchronize to synchronize), the viewer's on its
   render thread included.

Every frame on the card is a replay of one captured CUDA graph of its key
(mode, shape, tile, scene, BVH, whether a baked table exists), after the
key's one eager frame; its launch counts are the kernels that ran,
replays included (``utils.launches``).  A camera move keeps the graph.

On the cluster tier every frame's primary trace is one launch of the baked
walk (``cluster_closest_walk_baked``); the unbaked walk
(``cluster_closest_walk``) serves the bounce rays, and none in NORMALS.

Every brute-tier trace of a frame launches K3 after B1; every PATH bounce
launches K1 before its two traces and K2 after them, on both tiers.

Each main path runs with every launch count set to 0 just before it and
reads the counts just after; the kernels' ``launches`` are the sums of
those reads: phases 5-10, the row split's two paths and the spp split of
phase 12, the viewer of phase 13 and the graph frames of phase 15.  Each kernel's ``bound_ms`` is the larger of the bytes it
must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the
published H100 SXM peaks), counted from this run's inputs (B2: every table
row for a live ray that is not occluded, one test for an occluded one);
the walks of B3 and B4 count, whatever the
kernel did, the tests any walk needs that ends at the lanes' final bounds
(over every ray; B3's kernel may not have run fewer; the baked walk
counts its tests at BAKED_MT_OPS each).
K1-K3's bounds count each input and output once (K1 159 bytes a lane and
64 a light, K2 258, K3 82 and 140 a distinct table row) against the f32
operations counted in their sources (``path_kernel.OPS_SAMPLE``,
``OPS_COMBINE``, ``shade_kernel.OPS_SHADE``); beside the bound their record
holds the issue floor from their SASS (``issue_floor_ms``).
The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
# 3 warm-up frames: the key's eager frame, the capture of the frame graph, then replays (a deterministic mode:
# two single frames), so that no timed run captures
MAIN_RES, MAIN_DEPTH, WARMUP_FRAMES, TIMED_FRAMES = 1024, 4, 3, 16
BOUNCE_RAYS = 1 << 20
LTC_RANDOM_RAYS, LTC_RANDOM_LIGHTS = 1 << 20, 7
RATIO_SAMPLES = 4
GOLDEN_RES, GOLDEN_PATH_SPP, GOLDEN_DEPTH, GOLDEN_RATIO_FRAMES = 64, 4, 4, 4
# kernel vs plain: the same f32 operations (the kernels build with
# --fmad=false), so any difference is a fault, up to the rare tie on a
# shared edge where both versions find the same t on two triangles
ID_AGREE_MIN = 0.99999
RTOL, ATOL = 1e-5, 1e-6
# B6 vs plain: the same operations too, so all but the rays with a vertex
# within an ulp of the horizon are bit-equal; a fault in a clip case that
# only a few lanes reach stays under test_ltc_pallas' loose bounds, not
# under this floor
LTC_BIT_EQUAL_MIN = 0.9999
# the cluster tier: BASELINE config 5's terrain (2 * 707^2 = 999,698
# heightfield triangles + the Cornell walls) and config 6's gallery
TERRAIN_GRID, TERRAIN_RES, TERRAIN_FRAMES, TERRAIN_PATH_FRAMES = 708, 1024, 16, 8
GALLERY_RES = 512
# K4 is also held on SPD's tetra (the benchmark's 1,048,576-triangle scene) and on the textured gallery
TETRA_SCENE = os.path.join(ROOT, "portbench", "scenes", "spd-tetra", "scene.json")
# RATIO's visibility batch on the same tetra under three area lights (the benchmark's tetra3 cell): 4 shadow rays
# a pixel at 1024^2, 4,194,304 rays; the plain sweep's reference runs over slices of 1M lanes
TETRA3_SCENE = os.path.join(ROOT, "portbench", "scenes", "spd-tetra-3lights", "scene.json")
TETRA3_SAMPLES, RATIO_SWEEP_SLICE = 4, 1 << 20
GALLERY_SCENE = os.path.join(ROOT, "scenes", "gallery", "scene.json")
GALLERY_GOLDENS = {"gallery_diffuse": ("DIFFUSE", 1), "gallery_ltc": ("LTC_BASELINE", 1),
                   "gallery_path": ("PATH", 2)}  # tests/goldens/generate.py GALLERY_MODES
SAMPLE_TILE, SAMPLE_TILES = 1024, 64  # the kernels and their plain versions timed in turns on 64 seeded tiles of rays
# B3's walk kernel against its plain version: the same keys, but a packed key tied between two clusters keeps
# the cluster the kernel visited first, the plain version the lower id (B3 takes a cid on a strict decrease only)
CID_EQUAL_MIN = 0.9999
# a terrain with more than 256 superclusters (2 * 799^2 triangles, 312 superclusters): the walk kernels
# test supercluster boxes 256 a round, so this one takes two rounds per ray
ROUNDS_GRID, ROUNDS_RAYS = 800, 1 << 16
# the brute tier's cap: the largest terrain that stays at or under BRUTE_MAX_TRIS = 4096 triangles
# (2 * 45^2 + 12 = 4,062), and the next grid, which takes the cluster tier (2 * 46^2 + 12 = 4,244)
CAP_GRID = 46
CROSS_NORMALS_FRAMES, CROSS_PATH_FRAMES = 4, 8
# bounds: published peaks of one H100 SXM (NVIDIA data sheet, dense, without sparsity)
PEAK_F32_OPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
MT_OPS = 53  # f32 operations of one Moller-Trumbore test, counted in csrc mt_row
BAKED_MT_OPS = 27  # f32 operations of one shared-origin test, counted in csrc/cluster_trace.cu mt_tri(BakedTri)
# the baked walk against the unbaked one (tests/unit/test_baked_mt.py): the same triangle on 99.9 % of
# lanes (reassociated products may flip a tie within an ulp), the t of a shared winner within rtol 1e-4, atol 1e-3
BAKED_AGREE_MIN, BAKED_RTOL, BAKED_ATOL = 0.999, 1e-4, 1e-3
# the second camera origin of the baked walk's check, and the CLI's moved camera of phase 11
TERRAIN_MOVE = (60.0, 40.0, 80.0)
CLI_RES, CLI_SPP, CLI_CAM_FROM = 256, 2, (200.0, 320.0, -400.0)
# phases 12-14: the split's frames (two shares of the one card), the viewer's rounds of /status requests and an
# orbit, and a deadline for each of its waits
SPLIT_FRAMES, SPLIT_DEVICES, VIEWER_ROUNDS, VIEWER_STATUS_REQUESTS, VIEWER_DEADLINE_S = 4, 2, 3, 10, 120.0
# phase 15: frames through the frame graph against as many eager frames (config 5b: 3, at ~0.3 s a frame; the
# deterministic modes: 16 single frames); the interleaving's render(n)
GRAPH_FRAMES, GRAPH_FRAMES_5B, GRAPH_SINGLES, INTERLEAVE_FRAMES = 8, 3, 16, 3
CACHE_CLI_RES = 256
SLAB_OPS = 28  # one box of a walk: its slab test and the comparisons around it (csrc box_span, candidate)
B6_LUT_BYTES = 64 * 12 * 4  # the packed LTC table, read once
EDGE_LANES = 1 << 16  # the seeded edge lanes of K1 and K3


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least time in ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _any_tests(bt, tab, o, d, tm) -> int:
    """Ray/triangle tests that B2's answer needs on these rays, whatever the
    kernel does: every table row for a ray with t_max > 0 that is not
    occluded, one (the test that hits) for an occluded ray, none otherwise."""
    occluded = int(bt.trace_any_cuda(tab, o, d, tm).sum().item())
    return (int((tm > 0).sum().item()) - occluded) * tab.shape[0] + occluded


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(torch, plain, kernel, iters_plain: int, iters_kernel: int):
    """Plain, kernel, kernel, plain on one card; mean of each pair."""
    p1 = _time_ms(torch, plain, iters_plain)
    k1 = _time_ms(torch, kernel, iters_kernel)
    k2 = _time_ms(torch, kernel, iters_kernel)
    p2 = _time_ms(torch, plain, iters_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _close(a, b):
    return (a - b).abs() <= ATOL + RTOL * b.abs()


def _check_closest(torch, bt, tab, o, d, tm, label: str, coherent: bool) -> float:
    """B1 (for a coherent batch its voting form) against its plain version;
    returns the max abs error of t, u, v."""
    t_k, id_k, u_k, v_k = bt.trace_closest_cuda(tab, o, d, tm, coherent)
    t_p, id_p, u_p, v_p = bt.trace_closest_plain(tab, o, d, tm)
    torch.cuda.synchronize()
    same = id_k == id_p
    agree = same.float().mean().item()
    _require(agree >= ID_AGREE_MIN, f"B1 {label}: tri_id agrees on {agree:.7f} of rays (< {ID_AGREE_MIN})")
    _require(bool(_close(t_k[~same], t_p[~same]).all()),
             f"B1 {label}: rays with different tri_id have different t (not an edge tie)")
    err = 0.0
    for name, a, b in (("t", t_k, t_p), ("u", u_k, u_p), ("v", v_k, v_p)):
        _require(bool(_close(a[same], b[same]).all()), f"B1 {label}: {name} outside rtol {RTOL} / atol {ATOL}")
        err = max(err, (a[same] - b[same]).abs().max().item())
    hits = (id_p >= 0).sum().item()
    print(f"  B1 {label}: {o.shape[0]} rays, {hits} hits, tri_id agree {agree:.7f}, "
          f"max |t,u,v err| {err:.3g} (tol rtol {RTOL} atol {ATOL})", flush=True)
    return err


def _check_any(torch, bt, tab, o, d, tm, label: str) -> float:
    occ_k = bt.trace_any_cuda(tab, o, d, tm)
    occ_p = bt.trace_any_plain(tab, o, d, tm)
    torch.cuda.synchronize()
    agree = (occ_k == occ_p).float().mean().item()
    _require(agree >= ID_AGREE_MIN, f"B2 {label}: occlusion agrees on {agree:.7f} of rays (< {ID_AGREE_MIN})")
    print(f"  B2 {label}: {o.shape[0]} rays, {occ_p.sum().item()} occluded, agree {agree:.7f}", flush=True)
    return (occ_k.float() - occ_p.float()).abs().max().item()


def _same(a, b):
    """Equal, both NaN, or within RTOL/ATOL."""
    return (a == b) | (a.isnan() & b.isnan()) | _close(a, b)


def _fields(x) -> dict:
    """The tensors of a dataclass, or of a tuple of tensors and dataclasses, by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    out = {}
    for i, part in enumerate(x):
        out.update({f"{i}.{k}": v for k, v in _fields(part).items()} if dataclasses.is_dataclass(part)
                   else {str(i): part})
    return out


def _check_bits(torch, label: str, got, want, inputs: dict) -> float:
    """Every output of a kernel (``got``) bit-equal to its plain version's
    (``want``), NaN included; the lanes that differ are printed with their
    inputs (``inputs``: name -> lane-major tensor).  Returns the max abs error."""
    got, want = _fields(got), _fields(want)
    torch.cuda.synchronize()
    err, bad = 0.0, {}
    for name, w in want.items():
        g = got[name]
        _require(g.dtype == w.dtype and g.shape == w.shape, f"{label} {name}: {g.dtype} {tuple(g.shape)} from the "
                                                            f"kernel, {w.dtype} {tuple(w.shape)} from the plain version")
        if g.dtype == torch.float32:
            diff = g.view(torch.int32) != w.view(torch.int32)
            err = max(err, (g - w).nan_to_num(nan=0.0).abs().max().item() if g.numel() else 0.0)
        else:
            diff = g != w
        lanes = diff.reshape(diff.shape[0], -1).any(dim=1) if diff.dim() else diff
        if bool(lanes.any()):
            bad[name] = lanes.nonzero().flatten()
    for name, lanes in bad.items():
        print(f"  {label}: {name} differs on {lanes.numel()} lanes", flush=True)
        for i in lanes[:8].tolist():
            print(f"    lane {i}: kernel {got[name][i].tolist()}, plain {want[name][i].tolist()}; inputs "
                  + ", ".join(f"{k} {v[i].tolist()}" for k, v in inputs.items()), flush=True)
    _require(not bad, f"{label}: {sorted(bad)} not bit-equal to the plain version")
    return err


def _record_bounce_inputs(r) -> dict:
    """``bench_rays.record_bounce_inputs`` of one eager frame of ``r``: each kernel's arguments, a call each."""
    from optix_renderer_tpu_torch.utils.bench_rays import record_bounce_inputs

    rec = record_bounce_inputs(r)
    _require(len(rec["sample"]) == len(rec["combine"]) == r.path_depth and len(rec["shade"]) == 1 + r.path_depth,
             f"a PATH frame launched K1 {len(rec['sample'])}, K2 {len(rec['combine'])}, K3 {len(rec['shade'])} times")
    return rec


def _k1_edge_lanes(torch, pk, ds, s, rng):
    """EDGE_LANES lanes of a real bounce's state (``s``, ``rng``), seeded, in eight groups: dead lanes; shading
    normals in the frame's singular branch (n.z < -0.999999) and just outside it; grazing wo (v at 0, +-1e-7 and
    1e-4 off the tangent plane); lanes whose light sample has a zero solid-angle pdf (a vertex far out in the
    light's plane, |cos| < 1e-8 at the light); black, white and random base colours at alpha 0.01, 1 and between;
    random throughputs, zeros among them; and two groups of real lanes.  Returns (state, rng, {group: lanes})."""
    dev = s.p.device
    n = EDGE_LANES
    k = n // 8
    g = torch.Generator(device=dev).manual_seed(SEED)
    st = pk.PathState(**{f.name: getattr(s, f.name)[:n].clone() for f in dataclasses.fields(pk.PathState)})
    rnd = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731

    def unit(a):
        return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)

    groups = {name: slice(i * k, (i + 1) * k) for i, name in enumerate(
        ("dead", "singular frame", "grazing wo", "zero light pdf", "base colour and alpha", "throughput"))}
    st.alive[groups["dead"]] = False
    for name in list(groups)[1:]:
        st.alive[groups[name]] = True
    sl = groups["singular frame"]
    tilt = torch.tensor([0.0, 1e-4, 1.5e-3], device=dev).repeat_interleave(k // 3 + 1)[:k]  # n.z -1, -1 + 5e-9, -1 + 1.1e-6
    st.nrm[sl] = unit(torch.stack([tilt, torch.zeros_like(tilt), -torch.ones_like(tilt)], dim=-1))
    st.v[sl] = unit(st.nrm[sl] + 0.5 * (rnd(k, 3) - 0.5))
    sl = groups["grazing wo"]
    tangent = unit(torch.linalg.cross(st.nrm[sl], unit(rnd(k, 3) - 0.5)))
    off = torch.tensor([0.0, 1e-7, -1e-7, 1e-4], device=dev).repeat(k // 4 + 1)[:k, None]
    st.v[sl] = unit(tangent + off * st.nrm[sl])
    sl = groups["zero light pdf"]
    light_y = ds.light_v1[0, 1]
    st.p[sl] = torch.stack([torch.full((k,), -1e6, device=dev), light_y.expand(k), -1e6 + 1e5 * rnd(k)], dim=-1)
    st.nrm[sl] = torch.tensor([1.0, 0.0, 0.0], device=dev)  # the origin keeps the vertex's y exactly
    st.v[sl] = unit(torch.tensor([1.0, 0.1, 0.0], device=dev) + 0.1 * rnd(k, 3))
    sl = groups["base colour and alpha"]
    third = k // 3
    st.diffuse[sl] = rnd(k, 3)
    st.diffuse[sl][:third] = 0.0
    st.diffuse[sl][third:2 * third] = 1.0
    st.alpha[sl] = torch.tensor([0.01, 1.0], device=dev).repeat(k // 2 + 1)[:k]
    st.alpha[sl][:third] = 0.01 + 0.99 * rnd(third)
    sl = groups["throughput"]
    st.tp[sl] = 2.0 * rnd(k, 3)
    st.tp[sl][::5] = 0.0
    return st, rng[:n].clone(), groups


def _bounce_sass(built: dict) -> dict:
    """{kernel: SASS instructions on a lane's straight-line path} of the built K1-K3
    (``utils.brute_bench.sass_path`` over ``cuobjdump -sass``): the count the issue floors take."""
    from optix_renderer_tpu_torch.utils.brute_bench import BOUNCE_KERNELS, bounce_paths, cuobjdump_sass

    out = {k: v["instructions"] for lib in ("path_bounce", "brute_shade")
           for k, v in bounce_paths(cuobjdump_sass(built[lib][0])).items()}
    _require(sorted(out) == sorted(BOUNCE_KERNELS), f"SASS of K1-K3: found {sorted(out)}")
    return out


def _k4_sass(built: dict) -> int:
    """SASS instructions on K4's straight-line path (``utils.brute_bench.sass_path`` over ``cuobjdump -sass``)."""
    from optix_renderer_tpu_torch.utils.brute_bench import cuobjdump_sass, sass_functions, sass_path

    fns = [lines for name, lines in sass_functions(cuobjdump_sass(built["cluster_shade"][0])).items()
           if "cluster_shade_kernel" in name]
    _require(len(fns) == 1, f"SASS of K4: {len(fns)} functions named cluster_shade_kernel")
    return sass_path(fns[0])["instructions"]


def _check_cluster_shade(torch, sk, shade, ct, graph_ms, r, rays, key, cid, smi, label: str) -> dict:
    """K4 against its plain version (the winners' gather, then the fused build) on every lane of one batch of
    ``r``'s winners, bit for bit, one launch; its CUDA-event time in turns with the plain version's and as 30
    launches replayed in a CUDA graph, beside two byte bounds: 214 bytes a hit lane (key, cid, ray and fields
    a lane, the winner's rows a hit lane) and each distinct winning row read once."""
    args = (r.device_scene, r.bvh.shade_a, r.bvh.shade_b, rays, key, cid)
    n = key.shape[0]
    sk.reset_launch_counts()
    got = sk.cluster_shade_cuda(*args)
    _require(sk.LAUNCHES["cluster_shade"] == 1, f"K4 {label}: {sk.LAUNCHES} launches for one call")
    err = _check_bits(torch, f"K4 {label}", got, shade.shade_winners_plain(*args),
                      {"key": key, "cid": cid, "origin": rays.origin, "direction": rays.direction})
    del got
    ms, plain_ms = _in_turns(torch, lambda: shade.shade_winners_plain(*args), lambda: sk.cluster_shade_cuda(*args),
                             3, 30)
    g_ms = graph_ms(lambda: sk.cluster_shade_cuda(*args), 30)
    rows, hit = ct.winner_rows(key, cid)
    hits = int(hit.sum().item())
    distinct = torch.unique(rows[hit]).numel()
    lane_bound = _bound(n * sk.BYTES_WINNER + hits * sk.BYTES_WINNER_ROW, 0)
    bound = _bound(n * sk.BYTES_WINNER + distinct * sk.BYTES_WINNER_ROW, 0)
    print(f"  K4 {label}: {n} lanes, {hits} hits ({distinct} distinct triangles), bit-equal on every lane; "
          f"{ms:.4f} ms ({g_ms:.4f} replayed in a graph) vs plain {plain_ms:.4f} ms; bound {lane_bound[0]:.4f} ms "
          f"at 214 bytes a hit lane, {bound[0]:.4f} ms with each distinct row once ({bound[1]}) on {smi}", flush=True)
    return {"lanes": n, "hits": hits, "distinct_rows": distinct, "max_abs_err": err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound": bound, "hit_lane_bound_ms": lane_bound[0]}


def _cosine_bounce(torch, cm, bsdf, si, seed: int):
    """Cosine-sampled bounce rays (origin, direction) from the hits of ``si``, offset along the normal as the
    path tracer offsets them (miss lanes too: callers mask them)."""
    from optix_renderer_tpu_torch.integrators.path import RAY_EPS

    g = torch.Generator(device=si.p.device).manual_seed(seed)
    u = torch.rand((2, si.p.shape[0]), generator=g, device=si.p.device)
    _, to_world = cm.orthonormal_basis(si.n_geom)
    d = cm.normalize(cm.apply_mat(to_world, bsdf.sample_cosine_hemisphere(u[0], u[1])), eps=1e-30)
    return (si.p + si.n_geom * RAY_EPS).contiguous(), d.contiguous()


def _cluster_shade_scene(torch, sk, shade, ct, cm, bsdf, Ray, graph_ms, r, smi, label: str) -> dict:
    """K4 (``_check_cluster_shade``) on ``r``'s first-frame primary winners (the baked walk, as a frame traces
    them) and on the corridor-sorted winners of cosine bounce rays from their hits."""
    from optix_renderer_tpu_torch.accel.traverse import trace_closest_winners
    from optix_renderer_tpu_torch.engine.camera_kernel import pixel_order
    from optix_renderer_tpu_torch.utils.bench_rays import first_frame_primaries

    b = r.bvh
    prim = first_frame_primaries(r, pixel_order(r.width, r.height, r.device))
    key, cid, _t, _ = trace_closest_winners(b, prim, baked_tab=r.baked_tab)
    out = {"primaries": _check_cluster_shade(torch, sk, shade, ct, graph_ms, r, prim, key, cid, smi,
                                             f"{label} primary winners")}
    si = shade.shade_winners_plain(r.device_scene, b.shade_a, b.shade_b, prim, key, cid)
    bounce = Ray(*_cosine_bounce(torch, cm, bsdf, si, SEED + 7))
    key_b, cid_b, _t, _ = trace_closest_winners(b, bounce, active=si.hit, coherent=False)
    out["bounce"] = _check_cluster_shade(torch, sk, shade, ct, graph_ms, r, bounce, key_b, cid_b, smi,
                                         f"{label} cosine bounce winners (corridor-sorted trace)")
    return out


def _check_fmod_identity(torch, dev) -> int:
    """Bit patterns x on which |fmod(x, 1)| (the plain version's uv wrap) and |x - trunc(x)| (K3's) differ,
    over all 2^32 float32 patterns, in chunks of 2^28, computed on the card by the plain version's own
    operations (torch.fmod, torch.trunc) and compared as int32 bits, a NaN matching any NaN."""
    chunk, differ = 1 << 28, 0
    for c in range(16):
        bits = torch.arange(chunk, dtype=torch.int32, device=dev) + (-(1 << 31) + c * chunk)
        x = bits.view(torch.float32)
        a, b = torch.fmod(x, 1.0).abs(), (x - torch.trunc(x)).abs()
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        differ += int((~same).sum().item())
        del bits, x, a, b, same
    return differ


def _check_bounce_kernels(torch, pk, sk, shade, Hit, r, frame_impl, smi, sass) -> dict:
    """K1, K2 and K3 against their plain versions on the card (bit-equal on every lane), on the inputs an
    eager Cornell PATH frame gave them (every bounce, every trace) and on seeded edge lanes; each timed in turns
    with its plain version at the frame's 1M lanes (K1 and K2 at its second bounce, K3 at its primaries and
    that bounce), with its bound; then one whole frame through the kernels against one through the plain
    versions, from one state."""
    ds = r.device_scene
    rec = _record_bounce_inputs(r)
    out = {}

    def k1_inputs(st, rng):
        return {**{f.name: getattr(st, f.name) for f in dataclasses.fields(pk.PathState)}, "rng": rng}

    # K1: every bounce of the frame, then the edge lanes
    err1 = 0.0
    for d, (_ds, st, rng) in enumerate(rec["sample"]):
        err1 = max(err1, _check_bits(torch, f"K1 bounce {d}", pk.path_sample_cuda(ds, st, rng),
                                     pk.path_sample_plain(ds, st, rng), k1_inputs(st, rng)))
    est, erng, groups = _k1_edge_lanes(torch, pk, ds, rec["sample"][1][1], rec["sample"][1][2])
    want = pk.path_sample_plain(ds, est, erng)
    err1 = max(err1, _check_bits(torch, "K1 edge lanes", pk.path_sample_cuda(ds, est, erng), want,
                                 k1_inputs(est, erng)))
    zero_pdf = groups["zero light pdf"]
    _require(not bool(want.shadow_needed[zero_pdf].any()) and bool((want.nee[zero_pdf] == 0).all()),
             "K1 edge lanes: a light sample in the light's plane kept a nonzero NEE pdf")
    print(f"  K1 path_sample: {len(rec['sample'])} bounces of an eager Cornell PATH frame ({rec['sample'][0][2].numel()} "
          f"lanes each) and {EDGE_LANES} edge lanes ({', '.join(groups)}, real lanes; the edge lanes "
          f"{int(want.shadow_needed.sum())} shadow rays, {int(want.sample_ok.sum())} bounce rays): bit-equal on "
          "every lane", flush=True)

    # K2: every bounce, then the second bounce's inputs with seeded occlusion, misses and colours
    err2, light_hits, misses = 0.0, 0, 0
    for d, (n_l, color, st, b, occ, bsi) in enumerate(rec["combine"]):
        inputs = {"color": color, "tp": st.tp, "nee": b.nee, "shadow_needed": b.shadow_needed, "occluded": occ,
                  "sample_ok": b.sample_ok, "brdf": b.brdf, "cos_over_pdf": b.cos_over_pdf, "bsdf_pdf": b.bsdf_pdf,
                  "dir": b.bounce_dir, "hit": bsi.hit, "is_light": bsi.is_light, "b.p": bsi.p, "b.n": bsi.n_geom,
                  "b.area": bsi.area}
        err2 = max(err2, _check_bits(torch, f"K2 bounce {d}", pk.path_combine_cuda(n_l, color, st, b, occ, bsi),
                                     pk.path_combine_plain(n_l, color, st, b, occ, bsi), inputs))
        light_hits += int((b.sample_ok & bsi.hit & bsi.is_light).sum())
        misses += int((b.sample_ok & ~bsi.hit).sum())
    _require(light_hits > 0 and misses > 0, f"K2's inputs held {light_hits} light hits and {misses} misses")
    n_l, color, st, b, occ, bsi = rec["combine"][1]
    g = torch.Generator(device=color.device).manual_seed(SEED + 2)
    n = color.shape[0]
    occ_e = torch.rand(n, generator=g, device=color.device) < 0.5
    bsi_e = dataclasses.replace(bsi, hit=bsi.hit & (torch.rand(n, generator=g, device=color.device) < 0.75))
    color_e = torch.rand((n, 3), generator=g, device=color.device)
    err2 = max(err2, _check_bits(torch, "K2 edge lanes", pk.path_combine_cuda(n_l, color_e, st, b, occ_e, bsi_e),
                                 pk.path_combine_plain(n_l, color_e, st, b, occ_e, bsi_e),
                                 {"occluded": occ_e, "hit": bsi_e.hit, "is_light": bsi_e.is_light}))
    print(f"  K2 path_combine: {len(rec['combine'])} bounces ({light_hits} lanes whose bounce hit a light, {misses} "
          f"whose bounce missed) and the second bounce with seeded occlusion, misses and colours: bit-equal on "
          "every lane", flush=True)

    # K3: every trace of the frame, then seeded hits with misses, light triangles and u + v = 1
    err3 = 0.0
    for d, (_ds, hit) in enumerate(rec["shade"]):
        err3 = max(err3, _check_bits(torch, f"K3 trace {d}", sk.brute_shade_cuda(ds, hit),
                                     shade.build_surface_interaction(ds, None, hit),
                                     {"tri_id": hit.tri_id, "u": hit.bary_u, "v": hit.bary_v}))
    from optix_renderer_tpu_torch.scene.device import PACK_SLICES

    T = ds.tri_pack.shape[0]
    lights = torch.nonzero(ds.tri_pack[:, PACK_SLICES["is_light"][0]] > 0.5).flatten()
    tri = torch.randint(-1, T, (EDGE_LANES,), generator=g, device=color.device, dtype=torch.int32)
    tri[::4] = lights[torch.randint(0, lights.numel(), (EDGE_LANES // 4,), generator=g, device=color.device)].int()
    u = torch.rand(EDGE_LANES, generator=g, device=color.device)
    v = torch.rand(EDGE_LANES, generator=g, device=color.device) * (1.0 - u)
    v[::3] = 1.0 - u[::3]
    hit_e = Hit(t=torch.ones_like(u), tri_id=tri, bary_u=u, bary_v=v)
    err3 = max(err3, _check_bits(torch, "K3 edge lanes", sk.brute_shade_cuda(ds, hit_e),
                                 shade.build_surface_interaction(ds, None, hit_e), {"tri_id": tri, "u": u, "v": v}))
    print(f"  K3 brute_shade: {len(rec['shade'])} traces of the frame and {EDGE_LANES} seeded hits (misses, light "
          "triangles, u + v = 1): bit-equal on every lane", flush=True)

    # times in turns and bounds, at the frame's 1M lanes
    a1 = (ds, *rec["sample"][1][1:])
    a2 = rec["combine"][1]
    ms1, plain1 = _in_turns(torch, lambda: pk.path_sample_plain(*a1), lambda: pk.path_sample_cuda(*a1), 3, 30)
    ms2, plain2 = _in_turns(torch, lambda: pk.path_combine_plain(*a2), lambda: pk.path_combine_cuda(*a2), 3, 30)
    n = a1[2].numel()
    n_lights = ds.num_lights
    bound1 = _bound(n * pk.BYTES_SAMPLE + n_lights * pk.BYTES_LIGHT, n * pk.OPS_SAMPLE)
    bound2 = _bound(n * pk.BYTES_COMBINE, n * pk.OPS_COMBINE)
    shade_t = {}
    for label, (_ds, hit) in (("primary", rec["shade"][0]), ("bounce 1", rec["shade"][2])):
        ms3, plain3 = _in_turns(torch, lambda: shade.build_surface_interaction(ds, None, hit),
                                lambda: sk.brute_shade_cuda(ds, hit), 5, 50)
        hits = hit.tri_id >= 0
        rows = torch.unique(hit.tri_id[hits]).numel()
        shade_t[label] = {"ms": ms3, "plain_ms": plain3, "hits": int(hits.sum()), "distinct_rows": rows,
                          "lanes": hit.tri_id.numel(),
                          "bound": _bound(hit.tri_id.numel() * sk.BYTES_SHADE + rows * sk.BYTES_ROW,
                                          int(hits.sum()) * (sk.OPS_SHADE + sk.OPS_TEXTURE * ds.has_textures))}
    # the kernels' device time without the wrappers' host time: 30 launches in one CUDA graph, replayed, as in a
    # replayed frame; then the issue floors: a lane's straight-line SASS instructions at the SM clock read after
    # the timed launches
    from optix_renderer_tpu_torch.utils.brute_bench import graph_ms, issue_floor_ms

    graph1, graph2 = graph_ms(lambda: pk.path_sample_cuda(*a1), 30), graph_ms(lambda: pk.path_combine_cuda(*a2), 30)
    for label, (_ds, hit) in (("primary", rec["shade"][0]), ("bounce 1", rec["shade"][2])):
        shade_t[label]["graph_ms"] = graph_ms(lambda: sk.brute_shade_cuda(ds, hit), 30)

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])

    def floor(kernel, lanes):
        return {"sass_instructions": sass[kernel], "sm_clock_mhz": mhz,
                "issue_floor_ms": issue_floor_ms(lanes, sass[kernel], mhz)}

    for v in shade_t.values():
        v.update(floor("brute_shade_kernel", v["lanes"]))
    out["path_sample"] = {"max_abs_err": err1, "ms": ms1, "graph_ms": graph1, "plain_ms": plain1, "bound": bound1,
                          "lanes": n, **floor("path_sample_kernel", n)}
    out["path_combine"] = {"max_abs_err": err2, "ms": ms2, "graph_ms": graph2, "plain_ms": plain2, "bound": bound2,
                           "lanes": n, **floor("path_combine_kernel", n)}
    out["brute_shade"] = {"max_abs_err": err3, **shade_t["primary"], "bound": shade_t["primary"]["bound"],
                          "bounce 1": shade_t["bounce 1"]}

    def line(v):
        return (f"{v['ms']:.4f} ms ({v['graph_ms']:.4f} replayed in a graph) vs plain {v['plain_ms']:.4f} ms "
                f"(bound {v['bound'][0]:.4f} ms, {v['bound'][1]}; "
                f"issue floor {v['issue_floor_ms']:.4f} ms, {v['sass_instructions']} SASS instructions a lane at "
                f"{v['sm_clock_mhz']:.0f} MHz")

    print(f"  times on {smi} (CUDA events; plain, kernel, kernel, plain), {n} lanes: K1 {line(out['path_sample'])}); "
          f"K2 {line(out['path_combine'])}); K3 "
          + "; ".join(f"{k} {line(v)}; {v['hits']} hits, {v['distinct_rows']} rows)" for k, v in shade_t.items()),
          flush=True)
    del rec, a1, a2

    # one whole frame through the kernels against one through the plain versions, from one state
    kw = dict(mode=r.mode, width=r.width, height=r.height, path_depth=r.path_depth, ratio_samples=r.ratio_samples)
    got = frame_impl(r.state, ds, r.bvh, **kw)
    want = frame_impl(r.state, ds, r.bvh, plain=True, **kw)
    torch.cuda.synchronize()
    _require(bool(torch.equal(got[0].accum.view(torch.int32), want[0].accum.view(torch.int32))),
             f"the {r.width}^2 PATH frame through K0-K3 differs from the plain frame on "
             f"{int((got[0].accum != want[0].accum).any(dim=-1).sum())} pixels")
    for f in dataclasses.fields(got[1]):
        _require(bool(torch.equal(getattr(got[1], f.name), getattr(want[1], f.name))),
                 f"the PATH frame's g-buffer {f.name} differs from the plain frame's")
    counts_k, counts_p = got[2]["path_alive_counts"], want[2]["path_alive_counts"]
    _require(bool(torch.equal(counts_k, counts_p)), f"per-bounce counts {counts_k.tolist()} vs {counts_p.tolist()}")
    honest = r.width * r.height + int(counts_k[:, 1:].sum())
    out["frame"] = {"honest_rays": honest, "alive_per_bounce": counts_k.tolist(), "image_mean": got[0].accum.mean().item()}
    print(f"  one {r.width}^2 Cornell PATH depth {r.path_depth} frame through K0-K3 bit-equal to the frame through "
          f"their plain versions from the same state (accum, g-buffers), the same per-bounce counts "
          f"{counts_k.tolist()} and honest rays ({honest})", flush=True)
    return out


def _check_camera_kernel(torch, ck, camera_from_lookat, cam, dev, smi) -> dict:
    """K0 against its plain version on the card (states, origins and directions bit-equal on every lane, the
    frame id as an int and as a 0-d tensor) on the shapes of its tile arithmetic: the main path's frame at
    frame ids 0 and 2^32 - 10000 (the seed's frame id + 10007 wraps), a split tile, 1000 x 600 and 30 x 17
    (block edges 8 and 8, 2 and 1); then timed in turns with its plain version at the main path's frame, and
    as 30 launches in one CUDA graph, replayed, beside its byte bound."""
    from optix_renderer_tpu_torch.utils.brute_bench import graph_ms

    cases = [(MAIN_RES, MAIN_RES, 0, None, 0), (MAIN_RES, MAIN_RES, 0, None, 2**32 - 10000),
             (MAIN_RES, MAIN_RES, MAIN_RES // 4, MAIN_RES // 4, 5), (1000, 600, 0, None, 3), (30, 17, 0, None, 7)]
    for width, height, row_offset, rows, frame_id in cases:
        camera = camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, width, height, dev)
        want = ck.camera_rng_plain(camera, frame_id, width, height, row_offset, rows)
        label = f"K0 {width}x{height} rows {row_offset}+{rows or height} frame {frame_id}"
        for fid in (frame_id, torch.tensor(frame_id, dtype=torch.int64, device=dev)):
            _check_bits(torch, label, ck.camera_rng_cuda(camera, fid, width, height, row_offset, rows), want,
                        {"pixel": ck.pixel_order(width, height, dev, row_offset, rows)})
    tiles = ", ".join(f"{w}x{h} rows {ro}+{rows or h} frame {f}" for w, h, ro, rows, f in cases)
    print(f"  K0 camera_rng: {len(cases)} tiles ({tiles}), the frame id an int and a 0-d tensor: states, origins "
          "and directions bit-equal on every lane", flush=True)
    camera = camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, MAIN_RES, MAIN_RES, dev)
    fid = torch.tensor(1, dtype=torch.int64, device=dev)
    ms, plain_ms = _in_turns(torch, lambda: ck.camera_rng_plain(camera, fid, MAIN_RES, MAIN_RES),
                             lambda: ck.camera_rng_cuda(camera, fid, MAIN_RES, MAIN_RES), 5, 50)
    replayed = graph_ms(lambda: ck.camera_rng_cuda(camera, fid, MAIN_RES, MAIN_RES), 30)
    lanes = MAIN_RES * MAIN_RES
    bound = _bound(lanes * ck.BYTES_LANE, 0)
    print(f"  times on {smi} (CUDA events; plain, kernel, kernel, plain), {lanes} lanes: K0 {ms:.4f} ms "
          f"({replayed:.4f} replayed in a graph) vs plain {plain_ms:.4f} ms (bound {bound[0]:.4f} ms, {bound[1]}; "
          f"replayed at {bound[0] / replayed * 100:.1f} % of it)", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "graph_ms": replayed, "plain_ms": plain_ms, "bound": bound, "lanes": lanes,
            "tiles": len(cases)}


def _sweep_sass(built: dict) -> dict:
    """{kernel mode: SASS instructions a box over its passes} of the built K-sweep
    (``utils.brute_bench.sweep_box_instructions`` over ``cuobjdump -sass``): the count its dense issue estimate
    takes."""
    from optix_renderer_tpu_torch.utils.brute_bench import cuobjdump_sass, sweep_box_instructions

    out = sweep_box_instructions(cuobjdump_sass(built["sc_sweep"][0]))
    _require(sorted(out) == [0, 1, 2] and all(v > 0 for v in out.values()), f"SASS of K-sweep: found {out}")
    return out


def _check_sweep_kernel(torch, cluster, swk, tb, batches: dict, smi, sass: dict) -> dict:
    """K-sweep against the plain sweep on the card: the t bound (``ray_t_bounds``) and, for rays the renderer
    corridor-sorts, the key (``corridor_keys_and_t_bounds``), bit-equal on every lane; each timed in turns with
    its plain version and as 30 launches in one CUDA graph, replayed, beside its byte bound and its dense issue
    estimate: the SASS instructions a box of its passes times every box, a lane, at the SM clock read after the
    timed launches.  That is the issue time of a dense sweep, which tests every box; the kernel skips each run
    of 32 boxes whose union box a lane misses, so it can run below the estimate, which is no floor for it.
    ``batches``: label -> (rays, t_max, with a key)."""
    from optix_renderer_tpu_torch.utils.brute_bench import graph_ms, issue_floor_ms

    boxes = (tb.sc_min, tb.sc_max)
    S = tb.sc_min.shape[0]
    mode = 2 if 3 * cluster._cid_bits(S) <= 31 else 1
    out = {}
    for label, (rays, t_max, key) in batches.items():
        if key:
            def kernel():
                return cluster.corridor_keys_and_t_bounds(tb.cluster_min, tb.cluster_max, rays, t_max, sc_boxes=boxes)

            def plain():
                return cluster.corridor_keys_and_t_bounds_plain(tb.cluster_min, tb.cluster_max, rays, t_max)
        else:
            def kernel():
                return cluster.ray_t_bounds(tb.cluster_min, tb.cluster_max, rays, t_max, sc_boxes=boxes)

            def plain():
                return cluster.ray_t_bounds_plain(tb.cluster_min, tb.cluster_max, rays, t_max)
        swk.reset_launch_counts()
        got = kernel()
        _require(swk.LAUNCHES["sc_sweep"] == 1, f"K-sweep {label}: {swk.LAUNCHES} launches for one call")
        got, want = (got, plain()) if key else ((got,), (plain(),))  # (key, t bound) or (t bound,)
        _check_bits(torch, f"K-sweep {label}", got, want, {"origin": rays.origin, "direction": rays.direction})
        n = rays.origin.shape[0]
        ms, plain_ms = _in_turns(torch, plain, kernel, 2, 20)
        out[label] = {"lanes": n, "boxes": S, "key": key, "ms": ms, "graph_ms": graph_ms(kernel, 30),
                      "plain_ms": plain_ms, "bound": _bound(n * (swk.BYTES_LANE - (0 if key else 4)), 0),
                      "live": int((want[-1] > 0).sum())}
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    for v in out.values():
        per_lane = S * sass[mode if v["key"] else 0]
        v.update({"sass_instructions": per_lane, "sm_clock_mhz": mhz,
                  "dense_issue_ms": issue_floor_ms(v["lanes"], per_lane, mhz)})
    print(f"  K-sweep ({S} superclusters): t bound and key bit-equal to the plain sweep on every lane of "
          + ", ".join(out) + f"; times on {smi} (CUDA events; plain, kernel, kernel, plain): "
          + "; ".join(f"{k} {v['ms']:.4f} ms ({v['graph_ms']:.4f} replayed in a graph) vs plain {v['plain_ms']:.4f} "
                      f"ms (bound {v['bound'][0]:.4f} ms, {v['bound'][1]}; dense issue estimate {v['dense_issue_ms']:.4f} ms, "
                      f"{v['sass_instructions']:.0f} SASS instructions a lane at {v['sm_clock_mhz']:.0f} MHz; "
                      f"{v['live']} of {v['lanes']} t bounds above 0)" for k, v in out.items()), flush=True)
    return out


def _check_edges(torch, bt, bounce_like_rays, small, cap, dev) -> int:
    """B1 (both its forms) and B2 against their plain versions where the
    kernels' blocking has an edge: ``small`` and ``cap`` are the BVHs of Cornell and of the
    cap-shape terrain.  Every id and occlusion bit must be equal and every
    t, u, v within RTOL/ATOL (NaN equal to NaN).  Returns the case count."""
    res = bt.kernel_resources()
    block, chunk = 256 * res["rays_per_thread"], res["chunk_rows"]
    _require(cap.tri_tab.shape[0] > 2 * chunk, f"the cap table's {cap.tri_tab.shape[0]} rows fit two chunks of {chunk}")
    ragged = 3 * block + 77
    o_s, d_s, tc_s, ta_s = bounce_like_rays(small, ragged, dev, SEED + 1)
    o_c, d_c, tc_c, ta_c = bounce_like_rays(cap, ragged, dev, SEED + 2)
    lane = torch.arange(ragged, device=dev)
    odd = torch.where(lane % 4 == 0, float("nan"), torch.where(lane % 4 == 1, -1.0, 1.0))
    # rays that start one unit above triangles of the table's first rows and head straight back at them
    first = cap.tri_tab[lane % min(chunk, 64)]
    centre = first[:, 0:3] + (first[:, 3:6] + first[:, 6:9]) / 3.0
    nrm = first[:, 10:13]
    aimed = ((centre + nrm).contiguous(), (-nrm).contiguous())
    cases = [
        ("n = 1", small.tri_tab, o_s[:1], d_s[:1], torch.full((1,), 3.0e38, device=dev), torch.full((1,), 1200.0, device=dev)),
        (f"n = {ragged}, not a multiple of {block}, {cap.tri_tab.shape[0]} rows (more than two chunks)",
         cap.tri_tab, o_c, d_c, tc_c, ta_c),
        ("every ray dead", cap.tri_tab, o_c, d_c, torch.zeros_like(tc_c), torch.zeros_like(ta_c)),
        ("every ray live", cap.tri_tab, o_c, d_c, torch.full_like(tc_c, 3.0e38), torch.full_like(ta_c, 1200.0)),
        ("NaN and negative t_max", small.tri_tab, o_s, d_s, tc_s * odd, ta_s * odd),
        ("a table of 8 rows", small.tri_tab[:8].contiguous(), o_s, d_s, tc_s, ta_s),
        ("every ray occluded in the first chunk", cap.tri_tab, *aimed, torch.full_like(tc_c, 3.0e38),
         torch.full_like(ta_c, 10.0)),
    ]
    for label, tab, o, d, tm_c, tm_a in cases:
        o, d = o.contiguous(), d.contiguous()
        want = bt.trace_closest_plain(tab, o, d, tm_c)
        occ_k, occ_p = bt.trace_any_cuda(tab, o, d, tm_a), bt.trace_any_plain(tab, o, d, tm_a)
        for coherent in (False, True):  # B1 without and with the warps' vote
            got = bt.trace_closest_cuda(tab, o, d, tm_c, coherent)
            _require(bool((got[1] == want[1]).all()),
                     f"B1 edge case '{label}' (coherent={coherent}): tri_id differs from the plain version")
            for name, a, b in zip("tuv", (got[0], got[2], got[3]), (want[0], want[2], want[3])):
                _require(bool(_same(a, b).all()),
                         f"B1 edge case '{label}' (coherent={coherent}): {name} differs from the plain version")
        _require(bool((occ_k == occ_p).all()), f"B2 edge case '{label}': occlusion differs from the plain version")
        if label.startswith("every ray occluded"):
            _require(bool(occ_p.all()), "the aimed rays are not all occluded")
        print(f"  edge case '{label}': B1 {int((want[1] >= 0).sum().item())} hits of {o.shape[0]}, "
              f"B2 {int(occ_p.sum().item())} occluded; equal to the plain versions", flush=True)
    return len(cases)


def _crossover_frames(torch, np, Renderer, RendererType, scene, dev, smi: str, counts) -> dict:
    """One scene's NORMALS and PATH frames at 1024^2: host-clock ms/frame
    (unprofiled), then the device time and the trace kernels' time per
    frame from a profiled run of the same frames.  ``counts`` = (reset,
    read) of the launch counts: on the cluster tier each frame's primaries
    take the baked walk once, and the unbaked walk serves the bounces only."""
    from optix_renderer_tpu_torch.utils.profile_frames import KERNEL_STAGES, device_breakdown

    out: dict = {}
    for mode, frames in ((RendererType.NORMALS, CROSS_NORMALS_FRAMES), (RendererType.PATH, CROSS_PATH_FRAMES)):
        r = Renderer(scene, width=MAIN_RES, height=MAIN_RES, mode=mode, path_depth=MAIN_DEPTH, device=dev)

        def render():
            if mode == RendererType.NORMALS:  # a deterministic mode renders one frame per accumulation
                for _ in range(frames):
                    r.set_camera(scene.cameras[0])
                    r.render(1)
            else:
                r.render(frames)

        r.render(WARMUP_FRAMES)  # warm-up: the key's eager frame, then (PATH) the frame graph's capture
        if mode == RendererType.NORMALS:  # one frame per accumulation: the capture comes with the second
            r.set_camera(scene.cameras[0])
            r.render(1)
        counts[0]()
        t0 = time.perf_counter()
        render()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
        got = counts[1]()
        bounces = 0 if mode == RendererType.NORMALS else frames * MAIN_DEPTH
        want = ((frames, bounces, frames + 2 * bounces) if r.bvh.clustered else (0, 0, 0))
        _require((got["cluster_closest_walk_baked"], got["cluster_closest_walk"], got["sc_sweep"]) == want,
                 f"crossover {mode.name} ({r.bvh.num_tris} triangles): baked and unbaked walk and K-sweep launches "
                 f"{got['cluster_closest_walk_baked']}, {got['cluster_closest_walk']}, {got['sc_sweep']}, "
                 f"expected {want}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            render()
            torch.cuda.synchronize()
        b = device_breakdown(prof, frames, r.frame_stages())
        img = r.image()
        _require(bool(np.isfinite(img).all()) and float(np.abs(img).mean()) > 0.0, f"crossover {mode.name}: bad image")
        kernels = {k: v["device_ms_per_frame"] for k, v in b["stages"].items() if k in KERNEL_STAGES and v["calls_per_frame"]}
        out.update(triangles=r.bvh.num_tris, tier="cluster" if r.bvh.clustered else "brute")
        out[mode.name] = {"ms_per_frame": wall_ms, "device_ms_per_frame": b["device_ms_per_frame"],
                          "trace_kernels_ms_per_frame": sum(kernels.values()), "kernels_ms_per_frame": kernels}
        print(f"  crossover: {out['triangles']} triangles ({out['tier']} tier), "
              f"{mode.name} {MAIN_RES}^2, {frames} frames after warm-up: {wall_ms:.3f} ms/frame on the host clock; "
              f"profiled: device {b['device_ms_per_frame']:.3f} ms/frame, hand-written trace kernels "
              f"{sum(kernels.values()):.3f} ms/frame ({', '.join(f'{k} {v:.3f}' for k, v in kernels.items())}), on {smi}",
              flush=True)
    return out


def _check_ltc(torch, lk, args, label: str) -> float:
    """B6 against its plain version on the inputs ``args`` (origin, p,
    n_geom, alpha, diffuse, lights), with the tolerance of
    tests/unit/test_ltc_pallas.py:97-102 (a vertex z within an ulp of the
    horizon may take another clip case); returns the max abs error."""
    out_k = lk.ltc_direct_cuda(*args)
    out_p = lk.ltc_direct_plain(*args)
    torch.cuda.synchronize()
    fin_k, fin_p = torch.isfinite(out_k), torch.isfinite(out_p)
    _require(bool((fin_k == fin_p).all()), f"B6 {label}: the kernel and the plain version differ in which "
             "values are finite")
    k, p = out_k[fin_p], out_p[fin_p]
    diff = (k - p).abs()
    rel = diff / p.abs().clamp(min=1e-3)
    frac = (rel > 1e-3).float().mean().item()
    p99 = torch.quantile(rel, 0.99).item()
    err = diff.max().item()
    bit_equal = ((out_k == out_p) | ~fin_p).all(dim=-1).float().mean().item()
    _require(frac < 0.01 and p99 < 1e-3 and err < 5e-2,
             f"B6 {label}: {frac:.3g} of values above relative error 1e-3 (< 0.01), p99 {p99:.3g} (< 1e-3), "
             f"max abs {err:.3g} (< 5e-2)")
    _require(bit_equal >= LTC_BIT_EQUAL_MIN,
             f"B6 {label}: bit-equal on {bit_equal:.7f} of rays (< {LTC_BIT_EQUAL_MIN})")
    print(f"  B6 {label}: {args[0].shape[0]} rays x {args[5].shape[0]} lights, bit-equal rays {bit_equal:.7f}, "
          f"values above rel 1e-3 {frac:.3g}, p99 rel {p99:.3g}, max |err| {err:.3g}, "
          f"non-finite {int((~fin_p).sum().item())}, mean {p.mean().item():.5f}", flush=True)
    return err


def _no_implicit_syncs(torch, fn) -> list:
    """Run ``fn`` under CUDA sync debugging; returns where it synchronized,
    once per sync."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()  # Renderer.render ends in torch.cuda.synchronize(), which is not flagged
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sorted(f"{w.filename}:{w.lineno}" for w in caught if "synchronizing" in str(w.message))


def _tile_sample(torch, n_tiles: int, tile: int, device):
    """A seeded sample of SAMPLE_TILES tile ids (ascending) and their lanes."""
    g = torch.Generator().manual_seed(SEED)
    sel = torch.randperm(n_tiles, generator=g)[:SAMPLE_TILES].sort().values.to(device)
    return sel, (sel[:, None] * tile + torch.arange(tile, device=device)[None, :]).reshape(-1)


def _check_ray_walk(torch, ct, kind: str, bvh, o, d, extra, label: str) -> dict:
    """The walk of B3 (``kind`` "closest", ``extra`` = (key0, cid0)) or B4
    ("any", ``extra`` = (t_max,)), kernel against plain version on every
    ray and again on the lanes of SAMPLE_TILES seeded tiles: B4 equal on
    every lane; B3's key on every lane and its cluster id on CID_EQUAL_MIN
    of them (a packed key tied between two clusters keeps the one the
    kernel visited first, the plain version the lower id).  Times the
    kernel on every ray, and the kernel and the plain version in turns on
    the sample.  The bound does not depend on the implementation: from
    every lane's final bound, ``walk_bound_counts`` counts every
    supercluster box, the cluster boxes of the superclusters and the
    triangles of the clusters that pass within it, which B3's kernel cannot
    have undercut; the bytes are the rays, the outputs, the boxes and the
    table once."""
    tab, boxes = bvh.tri_tab, (bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max)
    closest = kind == "closest"
    name = "B3" if closest else "B4"
    cuda_fn = ct.trace_closest_walk_cuda if closest else ct.trace_any_walk_cuda
    plain_fn = ct.trace_closest_walk_plain if closest else ct.trace_any_walk_plain
    n = o.shape[0]
    work = torch.zeros(4, dtype=torch.int64, device=o.device)
    full = cuda_fn(tab, *boxes, o, d, *extra, work=work)
    t0 = time.perf_counter()
    every = plain_fn(tab, *boxes, o, d, *extra)
    torch.cuda.synchronize()
    every_s = time.perf_counter() - t0
    _sel, lanes = _tile_sample(torch, n // SAMPLE_TILE, SAMPLE_TILE, o.device)
    sub = (tab, *boxes, o[lanes].contiguous(), d[lanes].contiguous(), *(e[lanes].contiguous() for e in extra))
    plain = plain_fn(*sub)
    torch.cuda.synchronize()
    if closest:
        t_up = lambda k: (k | 63).view(torch.float32)  # noqa: E731
        err = (t_up(full[0]) - t_up(every[0])).abs().max().item()
        key_all, cid_all = (a.float().mean().item() for a in (full[0] == every[0], full[1] == every[1]))
        key_same, cid_same = ((full[0][lanes] == plain[0]).float().mean().item(),
                              (full[1][lanes] == plain[1]).float().mean().item())
        _require(key_all == 1.0 and key_same == 1.0,
                 f"B3 walk {label}: key differs from the plain walk's on {1 - key_all:.7f} of all lanes and "
                 f"{1 - key_same:.7f} of the sampled lanes")
        _require(min(cid_all, cid_same) >= CID_EQUAL_MIN,
                 f"B3 walk {label}: cluster id equal to the plain walk's on {cid_all:.7f} of all lanes and "
                 f"{cid_same:.7f} of the sampled lanes (< {CID_EQUAL_MIN})")
        hits = int((every[1] >= 0).sum().item())
        agree = (f"against the plain walk: key equal on {key_all:.7f} and cid on {cid_all:.7f} of all rays, "
                 f"{key_same:.7f} and {cid_same:.7f} of the sampled lanes")
        slabs_b, tests_b = ct.walk_bound_counts(*boxes, o, d, t_up(full[0]))
    else:
        err = (full.float() - every.float()).abs().max().item()
        same_all, same = (full == every).float().mean().item(), (full[lanes] == plain).float().mean().item()
        _require(same_all == 1.0 and same == 1.0,
                 f"B4 walk {label}: occlusion differs from the plain walk's on {1 - same_all:.7f} of all lanes and "
                 f"{1 - same:.7f} of the sampled lanes")
        hits = int(every.sum().item())
        agree = f"equal to the plain walk on {same_all:.7f} of all rays and {same:.7f} of the sampled lanes"
        slabs_b, tests_b = ct.walk_bound_counts(*boxes, o, d, extra[0], occluded=full)
    ms = _time_ms(torch, lambda: cuda_fn(tab, *boxes, o, d, *extra), 10)
    ms_sample, plain_ms = _in_turns(torch, lambda: plain_fn(*sub), lambda: cuda_fn(*sub), 1, 10)
    n_bytes = n * ((24 + 16) if closest else (24 + 4 + 1)) + tab.numel() * 4 + sum(b.numel() * 4 for b in boxes)
    bound_ms, bound_by = _bound(n_bytes, slabs_b * SLAB_OPS + tests_b * MT_OPS)
    slabs, tests, slab_slots, test_slots = (int(w) for w in work.tolist())
    # a walk that keeps the front-to-back rule visits at least what the final bounds need
    _require(not closest or (slabs_b <= slabs and tests_b <= tests),
             f"B3 walk {label}: the kernel ran {slabs} slab and {tests} ray/triangle tests, fewer than the "
             f"{slabs_b} and {tests_b} that its final bounds need")
    util_slab, util_test = slabs / max(slab_slots, 1), tests / max(test_slots, 1)
    print(f"  {name} walk, {label}: {n} rays, {hits} {'hits' if closest else 'occluded'}; {agree}, max |err| "
          f"{err:.3g}; the plain walk on every ray {every_s:.1f} s; the kernel ran {slabs} slab tests in "
          f"{slab_slots} lane slots (utilisation {util_slab:.4f}) and {tests} ray/triangle tests in {test_slots} "
          f"(utilisation {util_test:.4f}); any walk to these bounds needs {slabs_b} slab tests and {tests_b} "
          f"ray/triangle tests (counted over every ray); kernel {ms:.4f} ms (bound {bound_ms:.4f} ms, "
          f"{bound_by}); {SAMPLE_TILES}-tile sample: kernel {ms_sample:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "sample_ms": ms_sample, "bound_ms": bound_ms,
            "bound_by": bound_by, "slab_utilisation": util_slab, "test_utilisation": util_test,
            "plain_every_ray_s": every_s}


def _check_ratio_visibility(torch, cluster, ct, r, frame_impl, reset_counts, launch_counts) -> dict:
    """RATIO's one batched visibility trace on the cluster tier at the benchmark's size: one eager frame of ``r``
    (SPD's tetra under three area lights at 1024^2, 4 shadow samples a pixel: 4,194,304 rays), its launches
    counted, with the rays and t_max that ``ratio_color`` hands ``trace_any`` recorded as the cluster tier takes
    them (``cluster.trace_any_clusters``: unsorted), the t bound K-sweep and the bits B4 gave them in the frame,
    and the light samples' distances, from which the unmasked t_max (every ray traced) follows.  Then: the
    batch's t_max is the unmasked one, or +0 on the rays of the lanes a buffer does not read; the frame's
    accumulator and buffers bit-equal (int32 views) to a frame that traces the unmasked batch; on every ray,
    K-sweep's t bound bit-equal to the plain sweep's (run in slices of RATIO_SWEEP_SLICE lanes, which changes no
    lane's bits) and to a second launch of K-sweep; the frame's bits equal to a second launch of B4; B4's work
    counters zero on the +0 rays, and the batch's equal to its traced rays' alone; B4 against the plain walk
    (``_check_ray_walk``: every ray, the tile sample, the work counters, the times); and K-sweep, B4 and the
    batch (``cluster.trace_any_clusters``) timed on the masked and the unmasked batch in turns."""
    from optix_renderer_tpu_torch.core.types import Ray
    from optix_renderer_tpu_torch.integrators import ratio

    bvh = r.bvh
    boxes = (bvh.sc_min, bvh.sc_max)
    seen, dists = [], []
    any_clusters, sample, trace_any = cluster.trace_any_clusters, ratio._stochastic_direct_sample, ratio.trace_any

    def record(bvh_, rays, t_max, t_eff=None):  # trace_any_clusters, its two launches split out and kept
        _require(t_eff is None, "RATIO's visibility trace came with a t bound: not the unsorted path")
        before = dict(launch_counts())
        t_eff = cluster.ray_t_bounds(bvh_.cluster_min, bvh_.cluster_max, rays, t_max, sc_boxes=boxes)
        occ = any_clusters(bvh_, rays, t_max, t_eff=t_eff)
        after = launch_counts()
        seen.append((rays, t_max, t_eff, occ, {k: after[k] - before[k] for k in after if after[k] != before[k]}))
        return occ

    def record_sample(*args):  # a light sample, its distance kept
        out = sample(*args)
        dists.append(out[2])
        return out

    def frame():
        out = frame_impl(r.state, r.device_scene, bvh, mode=r.mode, width=r.width, height=r.height,
                         path_depth=r.path_depth, ratio_samples=r.ratio_samples, baked_tab=r.baked_tab)
        torch.cuda.synchronize()
        return out

    reset_counts()
    cluster.trace_any_clusters, ratio._stochastic_direct_sample = record, record_sample
    try:
        state, _gb, aux = frame()
    finally:
        cluster.trace_any_clusters, ratio._stochastic_direct_sample = any_clusters, sample
    frame_launches = {k: v for k, v in launch_counts().items() if v}
    _require(len(seen) == 1, f"a RATIO frame on the cluster tier made {len(seen)} unsorted visibility traces, not 1")
    rays, t_max, t_eff, occ, vis_launches = seen[0]
    n = r.width * r.height * r.ratio_samples
    _require(rays.origin.shape[0] == n and isinstance(t_max, torch.Tensor) and tuple(t_max.shape) == (n,),
             f"RATIO's visibility batch: {rays.origin.shape[0]} rays and t_max {getattr(t_max, 'shape', t_max)}, "
             f"expected {n} and a ({n},) tensor")
    _require(vis_launches == {"sc_sweep": 1, "cluster_any_walk": 1} and frame_launches.get("cluster_any_walk") == 1,
             f"RATIO's visibility batch launched {vis_launches}, the frame {frame_launches}: expected one K-sweep "
             "and one B4 for the batch, and no other B4 in the frame")
    _require(len(dists) == r.ratio_samples, f"{len(dists)} light samples, expected {r.ratio_samples}")
    t_full = torch.cat(dists).mul_(1.0 - 1e-3)  # the batch's t_max with every ray traced
    unread = t_max.view(torch.int32) == 0
    n_unread = int(unread.sum())
    kept = (t_max.view(torch.int32) == t_full.view(torch.int32)) | unread
    _require(bool(kept.all()) and 0 < n_unread < n and n_unread % r.ratio_samples == 0,
             f"RATIO's visibility batch: {int((~kept).sum())} rays whose t_max is neither the unmasked one nor +0, "
             f"{n_unread} of {n} at +0")

    def unmasked(bvh_, rays_, t_max=None):  # the same batch with every ray traced
        return trace_any(bvh_, rays_, t_max=t_full)

    ratio.trace_any = unmasked
    try:
        state_u, _gb_u, aux_u = frame()
    finally:
        ratio.trace_any = trace_any
    same = {"accum": torch.equal(state.accum.view(torch.int32), state_u.accum.view(torch.int32)),
            **{k: torch.equal(aux[k].view(torch.int32), aux_u[k].view(torch.int32)) for k in aux_u}}
    _require(sorted(aux) == sorted(aux_u) and all(same.values()),
             f"RATIO's frame with the unread rays at +0 differs from the one that traces every ray: {same}")

    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    t0 = time.perf_counter()
    want = torch.cat([cluster.ray_t_bounds_plain(bvh.cluster_min, bvh.cluster_max,
                                                 Ray(origin=o[s:s + RATIO_SWEEP_SLICE],
                                                     direction=d[s:s + RATIO_SWEEP_SLICE]),
                                                 t_max[s:s + RATIO_SWEEP_SLICE])
                      for s in range(0, n, RATIO_SWEEP_SLICE)])
    torch.cuda.synchronize()
    plain_sweep_s = time.perf_counter() - t0
    label = f"tetra3 RATIO {r.ratio_samples} x {r.width}^2 visibility rays, unsorted"
    inputs = {"origin": o, "direction": d, "t_max": t_max}
    _check_bits(torch, f"K-sweep {label} (the frame's)", (t_eff,), (want,), inputs)

    def sweep(t=t_max):
        return cluster.ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t, sc_boxes=boxes)

    _check_bits(torch, f"K-sweep {label} (a second launch)", (sweep(),), (want,), inputs)
    sweep_ms = _time_ms(torch, sweep, 10)
    again = ct.trace_any_walk_cuda(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, *boxes, o, d, t_eff)
    _require(bool(torch.equal(again, occ)), f"B4 {label}: the frame's bits differ from a second launch's on "
                                            f"{int((again != occ).sum())} lanes")
    b4 = _check_ray_walk(torch, ct, "any", bvh, o, d, (t_eff.contiguous(),), label)

    # B4's work: none on the +0 rays, so the batch's is its traced rays' alone
    work = {}
    for name, lanes in (("batch", slice(None)), ("+0 rays", unread), ("traced rays", ~unread)):
        w = torch.zeros(4, dtype=torch.int64, device=o.device)
        ct.trace_any_walk_cuda(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, *boxes, o[lanes].contiguous(),
                               d[lanes].contiguous(), t_eff[lanes].contiguous(), work=w)
        work[name] = [int(x) for x in w.tolist()]
    _require(work["+0 rays"] == [0, 0, 0, 0] and work["batch"] == work["traced rays"],
             f"B4 {label}: work (slab tests, triangle tests and their lane slots) {work}: expected none on the "
             "+0 rays and the batch's equal to the traced rays'")
    t_eff_full = sweep(t_full)
    w_full = torch.zeros(4, dtype=torch.int64, device=o.device)
    ct.trace_any_walk_cuda(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, *boxes, o, d, t_eff_full, work=w_full)
    work["unmasked batch"] = [int(x) for x in w_full.tolist()]

    # masked against unmasked, in turns (unmasked, masked, masked, unmasked), twice: K-sweep, B4, the batch
    def b4_on(te):
        return lambda: ct.trace_any_walk_cuda(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, *boxes, o, d, te)

    def batch_on(t):
        return lambda: any_clusters(bvh, rays, t)

    turns = {}
    for name, masked_fn, full_fn, iters in (("K-sweep", lambda: sweep(t_max), lambda: sweep(t_full), 10),
                                            ("B4", b4_on(t_eff), b4_on(t_eff_full), 5),
                                            ("batch", batch_on(t_max), batch_on(t_full), 5)):
        pairs = [_in_turns(torch, full_fn, masked_fn, iters, iters) for _ in range(2)]
        turns[name] = {"masked_ms": [m for m, _f in pairs], "unmasked_ms": [f for _m, f in pairs]}
        turns[name]["saved_ms"] = sum(f - m for m, f in pairs) / len(pairs)
    live = int((want > 0).sum())
    smi = _nvidia_smi()
    print(f"  RATIO's visibility batch on the tetra under three area lights ({bvh.num_tris} triangles, "
          f"{boxes[0].shape[0]} superclusters), one eager frame: {n} rays in one K-sweep and one B4 launch "
          f"(the frame's launches: {frame_launches}); {n - n_unread} rays traced ({(n - n_unread) / n:.4f}), "
          f"{n_unread} of miss and light lanes at t_max +0; the frame's accumulator and buffers bit-equal to one "
          f"that traces every ray; K-sweep's t bound bit-equal to the plain sweep's on every lane ({live} above 0; "
          f"the plain sweep {plain_sweep_s:.1f} s in slices of {RATIO_SWEEP_SLICE}), kernel {sweep_ms:.4f} ms; "
          f"B4's bits in the frame equal to a second launch's and to the plain walk's on every ray "
          f"({int(occ.sum())} occluded); B4's work [slabs, tests, slab slots, test slots] {work}", flush=True)
    for name, v in turns.items():
        print(f"  {name}, tetra3 RATIO batch, masked against unmasked in turns (CUDA events, {smi}): masked "
              f"{', '.join(f'{x:.4f}' for x in v['masked_ms'])} ms, unmasked "
              f"{', '.join(f'{x:.4f}' for x in v['unmasked_ms'])} ms; saved {v['saved_ms']:.4f} ms", flush=True)
    return {"lanes": n, "frame_launches": frame_launches, "visibility_launches": vis_launches,
            "traced": n - n_unread, "b4_work": work, "masked_vs_unmasked": turns,
            "sweep": {"lanes": n, "boxes": boxes[0].shape[0], "key": False, "ms": sweep_ms,
                      "plain_every_ray_s": plain_sweep_s, "live": live},
            "b4": b4}


def _check_baked(torch, ct, cluster, bvh, rays, baked, label: str) -> dict:
    """The baked walk of B3 on primaries that share ``baked.origin``: held
    against its plain version on the lanes of SAMPLE_TILES seeded tiles (key
    and cid on every lane: the same visits, the same f32 operations) and
    against the unbaked walk on every ray (the same triangle on
    BAKED_AGREE_MIN of lanes; the t in the keys within BAKED_RTOL /
    BAKED_ATOL where both found the same triangle); times it in turns with
    the unbaked walk on every ray and with its plain version on the sample.  The bound is ``walk_bound_counts`` of
    the final bounds with the baked test's operation count."""
    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    _require(bool((o == torch.as_tensor(baked.origin, device=o.device)).all()),
             f"baked walk {label}: the rays do not start at the table's origin {baked.origin}")
    boxes = (bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max)
    n = o.shape[0]
    t_eff = cluster.ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, 3.0e38, sc_boxes=(bvh.sc_min, bvh.sc_max))
    key0, cid0 = cluster.cold_start_keys(t_eff)
    work = torch.zeros(4, dtype=torch.int64, device=o.device)
    key, cid = ct.trace_closest_walk_cuda(baked.tab, *boxes, o, d, key0, cid0, work=work, baked=True)
    key_u, cid_u = ct.trace_closest_walk_cuda(bvh.tri_tab, *boxes, o, d, key0, cid0)
    _sel, lanes = _tile_sample(torch, n // SAMPLE_TILE, SAMPLE_TILE, o.device)
    sub = (baked.tab, *boxes, o[lanes].contiguous(), d[lanes].contiguous(), key0[lanes].contiguous(),
           cid0[lanes].contiguous())
    key_p, cid_p = ct.trace_closest_walk_plain(*sub, baked=True)
    torch.cuda.synchronize()
    t_up = lambda k: (k | 63).view(torch.float32)  # noqa: E731
    key_same = (key[lanes] == key_p).float().mean().item()
    cid_same = (cid[lanes] == cid_p).float().mean().item()
    _require(key_same == 1.0 and cid_same == 1.0,
             f"baked walk {label}: key equal to the plain baked walk's on {key_same:.7f} and cid on {cid_same:.7f} "
             "of the sampled lanes (every lane required)")
    err = (t_up(key[lanes]) - t_up(key_p)).abs().max().item()
    rows, hit = ct.winner_rows(key, cid)
    rows_u, hit_u = ct.winner_rows(key_u, cid_u)
    agree = (torch.where(hit, rows, -1) == torch.where(hit_u, rows_u, -1)).float().mean().item()
    _require(agree >= BAKED_AGREE_MIN,
             f"baked walk {label}: the unbaked walk's winner on {agree:.7f} of lanes (< {BAKED_AGREE_MIN})")
    # t as each kernel computed it, decoded from the packed keys, where both found the same triangle (the
    # exact t that decode_hits recomputes from the unbaked row is then the same by construction)
    same_w = hit & hit_u & (rows == rows_u)
    t_k, t_u = t_up(key)[same_w], t_up(key_u)[same_w]
    t_ok = ((t_k - t_u).abs() <= BAKED_ATOL + BAKED_RTOL * t_u.abs()).all().item()
    _require(bool(t_ok), f"baked walk {label}: the t of a shared winner outside rtol {BAKED_RTOL} / atol "
             f"{BAKED_ATOL} of the unbaked walk's")
    t_err = (t_k - t_u).abs().max().item()
    # the lanes whose winners differ: both hit another triangle (a tie, or an edge that one test's rounding
    # puts inside and the other's outside, in front of a farther surface), or only one of them hits
    h, h_u = (cluster.decode_hits(k, c, bvh.tri_tab, rays, t_eff) for k, c in ((key, cid), (key_u, cid_u)))
    other = hit & hit_u & (rows != rows_u)
    t_far = int((other & ((h.t - h_u.t).abs() > BAKED_ATOL + BAKED_RTOL * h_u.t.abs())).sum().item())
    n_other, n_one = int(other.sum().item()), int((hit != hit_u).sum().item())
    ms, unbaked_ms = _in_turns(torch, lambda: ct.trace_closest_walk_cuda(bvh.tri_tab, *boxes, o, d, key0, cid0),
                               lambda: ct.trace_closest_walk_cuda(baked.tab, *boxes, o, d, key0, cid0, baked=True),
                               10, 10)
    ms_sample, plain_ms = _in_turns(torch, lambda: ct.trace_closest_walk_plain(*sub, baked=True),
                                    lambda: ct.trace_closest_walk_cuda(*sub, baked=True), 1, 10)
    slabs_b, tests_b = ct.walk_bound_counts(*boxes, o, d, t_up(key))
    slabs, tests, slab_slots, test_slots = (int(w) for w in work.tolist())
    _require(slabs_b <= slabs and tests_b <= tests,
             f"baked walk {label}: the kernel ran {slabs} slab and {tests} ray/triangle tests, fewer than the "
             f"{slabs_b} and {tests_b} that its final bounds need")
    n_bytes = n * (24 + 16) + baked.tab.numel() * 4 + sum(b.numel() * 4 for b in boxes)
    bound_ms, bound_by = _bound(n_bytes, slabs_b * SLAB_OPS + tests_b * BAKED_MT_OPS)
    print(f"  B3 baked walk, {label}: {n} rays from {baked.origin.tolist()}, {int(hit.sum().item())} hits; "
          f"{SAMPLE_TILES}-tile sample: key and cid equal to the plain baked walk on every lane; against the "
          f"unbaked walk on all rays: winner {agree:.7f}, max |t err| of a shared winner {t_err:.3g}; "
          f"{n_other} lanes hit another triangle ({t_far} of them at a decoded t outside the tolerance), "
          f"{n_one} lanes hit in one walk only; the kernel ran {slabs} "
          f"slab tests in {slab_slots} lane slots and {tests} baked tests in {test_slots} (utilisation "
          f"{tests / max(test_slots, 1):.4f}); any walk to these bounds needs {slabs_b} and {tests_b}; kernel "
          f"{ms:.4f} ms vs unbaked walk {unbaked_ms:.4f} ms in turns (bound {bound_ms:.4f} ms, {bound_by}); "
          f"sample: kernel {ms_sample:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "unbaked_walk_ms": unbaked_ms, "plain_ms": plain_ms,
            "sample_ms": ms_sample, "bound_ms": bound_ms, "bound_by": bound_by, "winner_agree": agree,
            "max_shared_winner_t_err": t_err, "other_winner_lanes": n_other, "other_winner_far_lanes": t_far,
            "one_sided_hit_lanes": n_one, "test_utilisation": tests / max(test_slots, 1)}


def _sorted_rays(torch, cluster, bvh, rays, active, t_max):
    """What the port does with incoherent rays (accel/traverse.trace_closest_winners,
    cluster.trace_any_clusters_sorted): inactive lanes become above-scene
    up-rays, one supercluster sweep gives the corridor keys and t bounds,
    and the rays are sorted by key.  Returns (sorted origin, direction, t
    bound)."""
    rays_m = cluster.rays_above_scene(bvh, rays, active)
    keys, t_eff = cluster.corridor_keys_and_t_bounds(bvh.cluster_min, bvh.cluster_max, rays_m, t_max,
                                                     sc_boxes=(bvh.sc_min, bvh.sc_max))
    perm = torch.argsort(keys)
    return tuple(a[perm].contiguous() for a in (rays_m.origin, rays_m.direction, t_eff))


def _golden_rmse(got, want) -> float:
    """Relative RMSE, as tests/goldens/test_goldens.py::_check."""
    import numpy as np

    scale = max(float(np.abs(want).mean()), 1e-6)
    return float(np.sqrt(((got - want) ** 2).mean())) / scale


def _http(port: int, path: str, body: dict | None = None):
    """(answer, seconds) of one request to the viewer on localhost."""
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST") if body is not None else url
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as f:
        data = f.read()
    return (data if path == "/frame.png" else json.loads(data)), time.perf_counter() - t0


# one round of phase 13 from a process of its own, as a browser would send it: /status n times, an orbit,
# /status once more; prints the answers and their seconds as one JSON line.  Before its first timed request
# the client readies itself, as a browser is ready before it asks, and sends nothing meanwhile: it builds its
# URL opener (urllib's first ``urlopen`` in a process makes one, with a TLS context that loads the system's
# certificates), resolves the address once (the resolver's first call loads its modules) and parses a URL
# once (which compiles urllib's patterns).  That is tens of ms on the client alone (``opener_s``), which no
# answer of the viewer waits on
_VIEWER_CLIENT = r"""
import json, socket, sys, time, urllib.request
port, n = int(sys.argv[1]), int(sys.argv[2])
t0 = time.perf_counter()
opener = urllib.request.build_opener()
socket.getaddrinfo("127.0.0.1", port, 0, socket.SOCK_STREAM)
urllib.request.Request(f"http://127.0.0.1:{port}/control", data=b"{}", method="POST")
opener_s = time.perf_counter() - t0
def req(path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    r = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST") if body is not None else url
    t0 = time.perf_counter()
    with opener.open(r, timeout=120) as f:
        out = json.loads(f.read())
    return out, time.perf_counter() - t0
lat = [req("/status")[1] for _ in range(n)]
orbit, orbit_s = req("/control", {"op": "orbit", "daz": 0.15, "del": 0.05})
print(json.dumps({"status_s": lat, "orbit": orbit, "orbit_s": orbit_s, "after": req("/status")[0],
                  "opener_s": opener_s}))
"""


class _HeldFrame:
    """Wraps a Renderer's ``render_step_detached``: once armed, the next
    frame is enqueued and the calling thread then waits until ``release``.
    A control op sent meanwhile lands while that frame is in flight, so the
    viewer must drop it; without the hold an op can fall between two frames,
    where nothing is in flight to drop."""

    def __init__(self, step):
        self.step, self.armed = step, False
        self.holding, self.released = threading.Event(), threading.Event()

    def __call__(self):
        out = self.step()
        if self.armed:
            self.armed = False
            self.holding.set()
            _require(self.released.wait(VIEWER_DEADLINE_S), f"a held frame not released within {VIEWER_DEADLINE_S} s")
        return out

    def arm(self) -> None:
        self.holding.clear()
        self.released.clear()
        self.armed = True

    def release(self) -> None:
        self.armed = False
        self.released.set()


def _wait_for(cond, what: str, timeout: float = VIEWER_DEADLINE_S) -> None:
    t0 = time.monotonic()
    while not cond():
        _require(time.monotonic() - t0 < timeout, f"{what}: not within {timeout} s")
        time.sleep(0.005)


def main() -> int:
    # the script drives one card: show it only the first visible one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs a CUDA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "optix_renderer_tpu_torch")):
        print(f"chip_smoke: no optix_renderer_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    _require(torch.cuda.device_count() == 1, f"{torch.cuda.device_count()} cards visible, expected 1")
    sys.path.insert(0, ROOT)
    import numpy as np

    from optix_renderer_tpu_torch.accel import brute_trace as bt
    from optix_renderer_tpu_torch.accel import cluster
    from optix_renderer_tpu_torch.accel import cluster_trace as ct
    from optix_renderer_tpu_torch.accel import sweep_kernel as swk
    from optix_renderer_tpu_torch.accel.traverse import trace_closest_winners
    from optix_renderer_tpu_torch.core import math as cm
    from optix_renderer_tpu_torch.engine import RendererType
    from optix_renderer_tpu_torch.core.types import Hit, Ray
    from optix_renderer_tpu_torch.engine import camera_kernel as ck
    from optix_renderer_tpu_torch.engine import shade
    from optix_renderer_tpu_torch.engine import shade_kernel as sk
    from optix_renderer_tpu_torch.engine.camera import camera_from_lookat
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.postprocess.denoise import denoise_and_combine
    from optix_renderer_tpu_torch.integrators import path_kernel as pk
    from optix_renderer_tpu_torch.integrators.path import RAY_EPS
    from optix_renderer_tpu_torch.scene import SceneCamera, parse_scene, write_cornell_scene, write_terrain_scene
    from optix_renderer_tpu_torch.shading import bsdf
    from optix_renderer_tpu_torch.shading import ltc_kernel as lk
    from optix_renderer_tpu_torch.utils import cuda_build
    from optix_renderer_tpu_torch.utils.bench_rays import (bounce_like_rays, first_frame_primaries, ltc_frame_inputs,
                                                           random_ltc_inputs, random_shade_hits)
    from optix_renderer_tpu_torch.utils.profile_frames import device_breakdown
    from optix_renderer_tpu_torch.engine import frame_graph as fg
    from optix_renderer_tpu_torch.engine.modes import DETERMINISTIC_MODES
    from optix_renderer_tpu_torch.engine.renderer import _frame_impl

    def reset_counts():
        for mod in (bt, lk, ct, ck, pk, sk, swk):
            mod.reset_launch_counts()

    def launch_counts():
        return {**bt.LAUNCHES, **lk.LAUNCHES, **ct.LAUNCHES, **ck.LAUNCHES, **pk.LAUNCHES, **sk.LAUNCHES,
                **swk.LAUNCHES}

    def expected(**launched):
        return {**{k: 0 for k in launch_counts()}, **launched}

    phase_t0 = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"  ({name}: {now - phase_t0[0]:.1f} s)", flush=True)
        phase_t0[0] = now

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda", 0)
    captures = []  # every capture of a frame graph in this run: what, on which thread, host ms
    frame_graph = fg.FrameGraph

    class TimedGraph(frame_graph):
        """The frame slots' FrameGraph, its capture timed on the host clock."""

        def __init__(self, key, buf, ds, bvh, **static):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            super().__init__(key, buf, ds, bvh, **static)
            torch.cuda.synchronize(dev)
            captures.append({"frame": f"{RendererType(static['mode']).name} {static['width']}x{buf.rows}"
                                      f"+{buf.row_offset}", "thread": threading.current_thread().name,
                             "ms": (time.perf_counter() - t0) * 1e3, "ref": weakref.ref(self)})

    fg.FrameGraph = TimedGraph

    def warm_up(rend, cam, frames=WARMUP_FRAMES):
        """The key's eager frame and the capture of its graph, so that no timed frame captures: ``frames``
        frames, or in a deterministic mode (one frame per accumulation) two single frames."""
        if rend.mode in DETERMINISTIC_MODES:
            rend.render(1)
            rend.set_camera(cam)
            rend.render(1)
        else:
            rend.render(frames)

    def eager_frames(rend, state, n, every_gbuffer=False):
        """n ``_frame_impl`` frames from ``state`` (the pure reference): (the last state, each frame's
        (g-buffers, aux)); the g-buffers of the last frame only, unless ``every_gbuffer``."""
        frames = []
        for i in range(n):
            state, gb, aux = _frame_impl(
                state, rend.device_scene, rend.bvh, mode=rend.mode, width=rend.width, height=rend.height,
                path_depth=rend.path_depth, ratio_samples=rend.ratio_samples, baked_tab=rend.baked_tab)
            frames.append((gb if every_gbuffer or i == n - 1 else None, aux))
        return state, frames

    def same_frames(label, got_state, got_gb, got_aux, want_state, frames):
        """The Renderer's published state, g-buffers and aux against eager frames from the same state."""
        _require(got_state.accum_id == want_state.accum_id and bool(torch.equal(got_state.accum, want_state.accum)),
                 f"{label}: the accumulator differs from {len(frames)} eager frames")
        for f in dataclasses.fields(got_gb):
            _require(bool(torch.equal(getattr(got_gb, f.name), getattr(frames[-1][0], f.name))),
                     f"{label}: g-buffer {f.name} differs from the eager frame's")
        auxes = [a for _gb, a in frames]
        for k in auxes[0]:
            if k == "path_alive_counts":
                want = auxes[-1][k]
            else:  # RATIO: the mean over the frames, summed in frame order
                want = auxes[0][k]
                for a in auxes[1:]:
                    want = want + a[k]
                want = want / len(auxes)
            _require(bool(torch.equal(got_aux[k], want)), f"{label}: aux {k} differs from the eager frames'")

    def eager_rays(rend, frames):
        """(honest rays, alive_per_bounce of the last) of eager frames."""
        per_frame = rend.width * rend.height * (1 + (rend.ratio_samples if rend.mode == RendererType.RATIO else 0))
        alive = [a["path_alive_counts"] for _gb, a in frames if "path_alive_counts" in a]
        return (len(frames) * per_frame + sum(int(a[:, 1:].sum()) for a in alive),
                [int(x) for x in alive[-1][:, 0]] if alive else None)
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    phase_done("phase 1")

    # ---- 2. build: one nvcc per library, all started together --------------
    libs = {"brute_trace": bt.SOURCES, "ltc": lk.SOURCES, "cluster_trace": ct.SOURCES, "camera_rng": ck.SOURCES,
            "path_bounce": pk.SOURCES, "brute_shade": sk.SOURCES, "cluster_shade": sk.CLUSTER_SOURCES,
            "sc_sweep": swk.SOURCES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(cuda_build.build_library, name, srcs) for name, srcs in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    build_wall = time.perf_counter() - t0
    for mod in (bt, lk, ct, ck, pk, sk, swk):
        mod.kernel_library()
    sk.cluster_kernel_library()
    print(f"[2 build] {len(libs)} libraries in {build_wall:.2f} s wall", flush=True)
    for name, (lib_path, build_s) in built.items():
        with open(lib_path + ".log") as f:
            usage = [ln.split("info    :")[-1].strip() for ln in f if "Used" in ln or "spill" in ln]
        print(f"  {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s; ptxas: {usage}", flush=True)
        if name == "brute_trace":
            spills = [ln for ln in usage if "spill" in ln]
            _require(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
                     f"B1/B2 spill registers: {spills}")
    brute_res = bt.kernel_resources()
    print(f"  B1/B2: 256 threads a block, {brute_res['rays_per_thread']} rays a thread, chunks of "
          f"{brute_res['chunk_rows']} table rows, {brute_res['shared_bytes_per_block']} bytes of static shared "
          "memory a block; registers a thread in the ptxas lines above", flush=True)
    bounce_sass = _bounce_sass(built)
    print("  K1-K3, SASS instructions on a lane's straight-line path (brute_bench.sass_path): "
          + ", ".join(f"{k} {v}" for k, v in bounce_sass.items()), flush=True)
    k4_sass = _k4_sass(built)
    print(f"  K4, SASS instructions on a lane's straight-line path (brute_bench.sass_path): {k4_sass}", flush=True)
    sweep_sass = _sweep_sass(built)
    print("  K-sweep, SASS instructions a box over its passes (brute_bench.sweep_box_instructions): "
          + ", ".join(f"{('t bound', 'key of first and last', 'key of first, middle and last')[k]} {v:.2f}"
                      for k, v in sorted(sweep_sass.items())), flush=True)
    phase_done("phase 2")

    # ---- 3. kernels vs plain at the main paths' shapes --------------------
    cornell = parse_scene(os.path.join(ROOT, "scenes", "cornell", "scene.json"))
    cornell3 = parse_scene(os.path.join(ROOT, "scenes", "cornell3", "scene.json"))
    r = Renderer(cornell, width=MAIN_RES, height=MAIN_RES, mode=RendererType.PATH,
                 path_depth=MAIN_DEPTH, device=dev)
    rl = Renderer(cornell, width=MAIN_RES, height=MAIN_RES, mode=RendererType.LTC_BASELINE, device=dev)
    rr = Renderer(cornell3, width=MAIN_RES, height=MAIN_RES, mode=RendererType.RATIO,
                  ratio_samples=RATIO_SAMPLES, device=dev)
    tab = r.bvh.tri_tab
    n_px = MAIN_RES * MAIN_RES
    prim = first_frame_primaries(r, torch.arange(n_px, dtype=torch.int64, device=dev))
    prim_tm = torch.full((n_px,), 3.0e38, device=dev)
    bo, bd, btm_c, btm_a = bounce_like_rays(r.bvh, BOUNCE_RAYS, dev, SEED)
    print(f"[3 kernels] Cornell table {tuple(tab.shape)} ({r.bvh.num_tris} triangles)", flush=True)
    err_c = max(_check_closest(torch, bt, tab, prim.origin, prim.direction, prim_tm, "primary 1024^2", True),
                _check_closest(torch, bt, tab, bo, bd, btm_c, "bounce 1M", False))
    err_a = _check_any(torch, bt, tab, bo, bd, btm_a, "shadow 1M")
    ms_c, plain_c = _in_turns(
        torch, lambda: bt.trace_closest_plain(tab, prim.origin, prim.direction, prim_tm),
        lambda: bt.trace_closest_cuda(tab, prim.origin, prim.direction, prim_tm, True), 5, 50)
    ms_cb, plain_cb = _in_turns(
        torch, lambda: bt.trace_closest_plain(tab, bo, bd, btm_c),
        lambda: bt.trace_closest_cuda(tab, bo, bd, btm_c), 5, 50)
    ms_a, plain_a = _in_turns(
        torch, lambda: bt.trace_any_plain(tab, bo, bd, btm_a),
        lambda: bt.trace_any_cuda(tab, bo, bd, btm_a), 5, 50)
    print(f"  times on {smi} (CUDA events; plain, kernel, kernel, plain): "
          f"B1 primary 1024^2 {ms_c:.4f} ms vs plain {plain_c:.4f} ms; "
          f"B1 bounce 1M {ms_cb:.4f} ms vs plain {plain_cb:.4f} ms; "
          f"B2 shadow 1M {ms_a:.4f} ms vs plain {plain_a:.4f} ms", flush=True)
    bad_fmod = _check_fmod_identity(torch, dev)
    print(f"  |fmod(x, 1)| and |x - trunc(x)| (K3's uv wrap) on all 2^32 float32 bit patterns on the card: "
          f"{bad_fmod} differ", flush=True)
    _require(bad_fmod == 0, f"|fmod(x, 1)| and |x - trunc(x)| differ on {bad_fmod} float32 bit patterns")
    bounce_k = _check_bounce_kernels(torch, pk, sk, shade, Hit, r, _frame_impl, smi, bounce_sass)
    bounce_k["camera_rng"] = _check_camera_kernel(torch, ck, camera_from_lookat, cornell.cameras[0], dev, smi)
    ltc_l2, ltc_l6 = ltc_frame_inputs(rl), ltc_frame_inputs(rr)
    ltc_rand = random_ltc_inputs(LTC_RANDOM_RAYS, LTC_RANDOM_LIGHTS, SEED, dev)
    err_l = max(_check_ltc(torch, lk, ltc_l2, "Cornell LTC frame 1024^2"),
                _check_ltc(torch, lk, ltc_l6, "Cornell-3 LTC frame 1024^2"),
                _check_ltc(torch, lk, ltc_rand, "random 1M"))
    ltc_times, ltc_bounds, ltc_ops = {}, {}, {}
    for label, args in (("L=2", ltc_l2), ("L=6", ltc_l6), ("random L=7", ltc_rand)):
        ltc_times[label] = _in_turns(torch, lambda: lk.ltc_direct_plain(*args),
                                     lambda: lk.ltc_direct_cuda(*args), 3, 20)
        # 13 floats in and 3 out a ray, each light's row and the LUT once; the f32 operations these hits need
        n_r, n_lt = args[0].shape[0], args[5].shape[0]
        ltc_ops[label] = lk.ltc_direct_ops(*args)
        ltc_bounds[label] = _bound(n_r * 64 + n_lt * 64 + B6_LUT_BYTES, ltc_ops[label])
    del ltc_l6, ltc_rand
    print(f"  times on {smi} (CUDA events; plain, kernel, kernel, plain): "
          + "; ".join(f"B6 {k} {v[0]:.4f} ms vs plain {v[1]:.4f} ms (bound {ltc_bounds[k][0]:.4f} ms, "
                      f"{ltc_bounds[k][1]}; {ltc_ops[k]} operations)" for k, v in ltc_times.items()), flush=True)
    # bounds: each input byte read once, each output byte written once
    rows = tab.shape[0]
    bound_c = _bound(n_px * (28 + 16) + rows * 40, n_px * rows * MT_OPS)
    bound_a = _bound(BOUNCE_RAYS * (24 + 4 + 1) + rows * 40, _any_tests(bt, tab, bo, bd, btm_a) * MT_OPS)
    bound_l = ltc_bounds["L=2"]
    print(f"  bounds: B1 primary {bound_c[0]:.4f} ms ({bound_c[1]}), B2 shadow {bound_a[0]:.4f} ms ({bound_a[1]}), "
          f"B6 L=2 {bound_l[0]:.4f} ms ({bound_l[1]})", flush=True)

    # B1 and B2 at the brute tier's cap, their blocking's edge cases, and the crossover to the cluster tier
    with tempfile.TemporaryDirectory() as tmp:
        cap_scene = parse_scene(write_terrain_scene(tmp, grid=CAP_GRID, width=MAIN_RES, height=MAIN_RES))
        over_scene = parse_scene(write_terrain_scene(tmp, grid=CAP_GRID + 1, width=MAIN_RES, height=MAIN_RES))
    rc = Renderer(cap_scene, width=MAIN_RES, height=MAIN_RES, mode=RendererType.NORMALS, device=dev)
    capb = rc.bvh
    _require(not capb.clustered, f"the grid-{CAP_GRID} terrain ({capb.num_tris} triangles) left the brute tier")
    tab_c = capb.tri_tab
    prim_c = first_frame_primaries(rc, ck.pixel_order(MAIN_RES, MAIN_RES, dev))
    po_c, pd_c = prim_c.origin.contiguous(), prim_c.direction.contiguous()
    co, cd, ctm_c, ctm_a = bounce_like_rays(capb, BOUNCE_RAYS, dev, SEED)
    print(f"  cap shape: terrain grid {CAP_GRID}, {capb.num_tris} triangles, table {tuple(tab_c.shape)}", flush=True)
    err_c = max(err_c, _check_closest(torch, bt, tab_c, po_c, pd_c, prim_tm, "cap primary 1024^2", True),
                _check_closest(torch, bt, tab_c, co, cd, ctm_c, "cap bounce 1M", False))
    err_a = max(err_a, _check_any(torch, bt, tab_c, co, cd, ctm_a, "cap shadow 1M"))
    cap_c, cap_plain_c = _in_turns(torch, lambda: bt.trace_closest_plain(tab_c, po_c, pd_c, prim_tm),
                                   lambda: bt.trace_closest_cuda(tab_c, po_c, pd_c, prim_tm, True), 1, 5)
    cap_cb, cap_plain_cb = _in_turns(torch, lambda: bt.trace_closest_plain(tab_c, co, cd, ctm_c),
                                     lambda: bt.trace_closest_cuda(tab_c, co, cd, ctm_c), 1, 5)
    cap_a, cap_plain_a = _in_turns(torch, lambda: bt.trace_any_plain(tab_c, co, cd, ctm_a),
                                   lambda: bt.trace_any_cuda(tab_c, co, cd, ctm_a), 1, 5)
    rows_c = tab_c.shape[0]
    cap_bound_c = _bound(n_px * (28 + 16) + rows_c * 40, n_px * rows_c * MT_OPS)
    cap_bound_cb = _bound(BOUNCE_RAYS * (28 + 16) + rows_c * 40, int((ctm_c > 0).sum().item()) * rows_c * MT_OPS)
    cap_bound_a = _bound(BOUNCE_RAYS * (24 + 4 + 1) + rows_c * 40, _any_tests(bt, tab_c, co, cd, ctm_a) * MT_OPS)
    print(f"  cap-shape times on {smi} (CUDA events; plain, kernel, kernel, plain): "
          f"B1 primary 1024^2 {cap_c:.4f} ms vs plain {cap_plain_c:.4f} ms (bound {cap_bound_c[0]:.4f} ms, "
          f"{cap_bound_c[1]}); B1 bounce 1M {cap_cb:.4f} ms vs plain {cap_plain_cb:.4f} ms (bound "
          f"{cap_bound_cb[0]:.4f} ms, {cap_bound_cb[1]}); B2 shadow 1M {cap_a:.4f} ms vs plain {cap_plain_a:.4f} ms "
          f"(bound {cap_bound_a[0]:.4f} ms, {cap_bound_a[1]})", flush=True)
    # K3 at the cap: seeded hits on the largest brute-tier table, through the padded copy at its largest
    ds_c = rc.device_scene
    hit_c = random_shade_hits(ds_c, BOUNCE_RAYS, SEED + 3, dev)
    err_k3c = _check_bits(torch, "K3 cap hits", sk.brute_shade_cuda(ds_c, hit_c),
                          shade.build_surface_interaction(ds_c, None, hit_c),
                          {"tri_id": hit_c.tri_id, "u": hit_c.bary_u, "v": hit_c.bary_v})
    ms_k3c, plain_k3c = _in_turns(torch, lambda: shade.build_surface_interaction(ds_c, None, hit_c),
                                  lambda: sk.brute_shade_cuda(ds_c, hit_c), 3, 30)
    from optix_renderer_tpu_torch.utils.brute_bench import graph_ms, issue_floor_ms

    graph_k3c = graph_ms(lambda: sk.brute_shade_cuda(ds_c, hit_c), 30)
    hits_c = int((hit_c.tri_id >= 0).sum())
    bound_k3c = _bound(BOUNCE_RAYS * sk.BYTES_SHADE + torch.unique(hit_c.tri_id[hit_c.tri_id >= 0]).numel()
                       * sk.BYTES_ROW, hits_c * sk.OPS_SHADE)
    k3_floor = issue_floor_ms(BOUNCE_RAYS, bounce_sass["brute_shade_kernel"],
                              bounce_k["path_sample"]["sm_clock_mhz"])
    bounce_k["brute_shade"]["cap"] = {
        "rows": ds_c.tri_pack.shape[0], "padded_row_bytes": sk.padded_pack(ds_c.tri_pack).stride(0) * 4,
        "lanes": BOUNCE_RAYS, "hits": hits_c, "max_abs_err": err_k3c, "ms": ms_k3c, "graph_ms": graph_k3c,
        "plain_ms": plain_k3c,
        "bound_ms": bound_k3c[0], "bound_by": bound_k3c[1], "issue_floor_ms": k3_floor}
    print(f"  K3 at the cap: {BOUNCE_RAYS} seeded hits ({hits_c} hits) on the grid-{CAP_GRID} terrain's "
          f"{ds_c.tri_pack.shape[0]} rows (padded copy {sk.padded_pack(ds_c.tri_pack).numel() * 4} bytes): "
          f"bit-equal on every lane; {ms_k3c:.4f} ms ({graph_k3c:.4f} replayed in a graph) vs plain "
          f"{plain_k3c:.4f} ms (bound {bound_k3c[0]:.4f} ms, "
          f"{bound_k3c[1]}; issue floor {k3_floor:.4f} ms) on {smi}", flush=True)
    n_edges = _check_edges(torch, bt, bounce_like_rays, r.bvh, capb, dev)
    del rc, prim_c, po_c, pd_c, co, cd, ctm_c, ctm_a
    cross = [_crossover_frames(torch, np, Renderer, RendererType, sc, dev, smi, (reset_counts, launch_counts))
             for sc in (cap_scene, over_scene)]
    _require(cross[0]["tier"] == "brute" and cross[1]["tier"] == "cluster",
             f"the crossover scenes took the tiers {cross[0]['tier']} and {cross[1]['tier']}")
    del cap_scene, over_scene

    # the cluster tier on the 1M-triangle terrain (BASELINE config 5)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        terrain = parse_scene(write_terrain_scene(tmp, grid=TERRAIN_GRID, width=TERRAIN_RES, height=TERRAIN_RES))
        rt = Renderer(terrain, width=TERRAIN_RES, height=TERRAIN_RES, mode=RendererType.NORMALS,
                      path_depth=MAIN_DEPTH, device=dev)
        setup_s = time.perf_counter() - t0
    tb = rt.bvh
    C = tb.num_clusters
    _require(tb.clustered and tb.num_tris > 4096, "the terrain does not take the cluster tier")
    print(f"  terrain: {tb.num_tris} triangles, {C} clusters, table {tuple(tb.tri_tab.shape)}, "
          f"write + parse + build {setup_s:.1f} s", flush=True)
    n_t = TERRAIN_RES * TERRAIN_RES
    prim_t = first_frame_primaries(rt, ck.pixel_order(TERRAIN_RES, TERRAIN_RES, dev))  # the renderer's block order
    t_eff = cluster.ray_t_bounds(tb.cluster_min, tb.cluster_max, prim_t, 3.0e38, sc_boxes=(tb.sc_min, tb.sc_max))
    key0, cid0 = cluster.cold_start_keys(t_eff)
    # the walks on every ray against their plain versions: the coherent primaries first
    b3p = _check_ray_walk(torch, ct, "closest", tb, prim_t.origin, prim_t.direction, (key0, cid0),
                          "terrain primary 1024^2")
    key_p, cid_p = ct.trace_closest_walk_cuda(tb.tri_tab, tb.cluster_min, tb.cluster_max, tb.sc_min, tb.sc_max,
                                              prim_t.origin, prim_t.direction, key0, cid0)
    # K4 on the primaries' winners, every lane
    k4 = {"terrain primaries": _check_cluster_shade(torch, sk, shade, ct, graph_ms, rt, prim_t, key_p, cid_p, smi,
                                                    "terrain primary winners")}
    # 1M cosine bounce rays from the primary hits, and 1M NEE shadow rays
    si_p = shade.shade_winners_plain(rt.device_scene, tb.shade_a, tb.shade_b, prim_t, key_p, cid_p)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand((4, n_t), generator=g, device=dev)
    _, to_world = cm.orthonormal_basis(si_p.n_geom)
    d_b = cm.normalize(cm.apply_mat(to_world, bsdf.sample_cosine_hemisphere(u[0], u[1])), eps=1e-30)
    org_b = si_p.p + si_p.n_geom * RAY_EPS
    bounce = Ray(origin=org_b, direction=d_b)
    ob, db, teb = _sorted_rays(torch, cluster, tb, bounce, si_p.hit, 3.0e38)
    key_b, cid_b, _t, _ = trace_closest_winners(tb, bounce, active=si_p.hit, coherent=False)
    k4["terrain bounce"] = _check_cluster_shade(torch, sk, shade, ct, graph_ms, rt, bounce, key_b, cid_b, smi,
                                                "terrain 1M cosine bounce winners (corridor-sorted trace)")
    del key_b, cid_b
    ds_t = rt.device_scene
    lidx = torch.randint(0, ds_t.num_lights, (n_t,), generator=g, device=dev)
    lp = cm.sample_point_on_triangle(ds_t.light_v1[lidx], ds_t.light_v2[lidx], ds_t.light_v3[lidx], u[2], u[3])
    to_light = lp - org_b
    dist = cm.length(to_light)
    ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]
    needed = si_p.hit & ~si_p.is_light & (cm.dot(si_p.n_geom, ldir) > 0.0)
    tm_s = torch.where(needed, dist * (1.0 - 1e-3), 0.0)
    shadow = Ray(origin=org_b, direction=ldir)
    os_, ds_, tes = _sorted_rays(torch, cluster, tb, shadow, tm_s > 0.0, tm_s)
    # K-sweep on the same rays as a frame hands them to it: the primaries' t bound, the bounce and shadow rays'
    # key and t bound with their dead lanes moved above the scene
    t_inf = torch.full((n_t,), 3.0e38, device=dev)
    sweep_k = _check_sweep_kernel(torch, cluster, swk, tb, {
        "1024^2 primaries": (prim_t, t_inf, False),
        "1M cosine bounce rays": (cluster.rays_above_scene(tb, bounce, si_p.hit), t_inf, True),
        "1M NEE shadow rays": (cluster.rays_above_scene(tb, shadow, tm_s > 0.0), tm_s, True)}, smi, sweep_sass)
    # the walks on the incoherent rays as a frame sorts them, against their plain versions on every ray
    b3w = _check_ray_walk(torch, ct, "closest", tb, ob, db, cluster.cold_start_keys(teb),
                          "terrain 1M cosine bounce, corridor-sorted")
    b4w = _check_ray_walk(torch, ct, "any", tb, os_, ds_, (tes,), "terrain 1M NEE shadow, corridor-sorted")
    # the baked walk on the same primaries, from the Renderer's own table, then at a second camera origin
    cam0 = terrain.cameras[0]
    _require(rt.baked_tab is not None and bool(np.array_equal(rt.baked_tab.origin, np.float32(cam0.from_))),
             "the terrain Renderer on the card holds no table baked for its camera")
    b3k = {"camera 0": _check_baked(torch, ct, cluster, tb, prim_t, rt.baked_tab, "terrain primary 1024^2, camera 0")}
    bake_ms = _time_ms(torch, lambda: cluster.bake_shared_origin_tab(tb.tri_tab, cam0.from_), 5)
    cam1 = SceneCamera(from_=np.float32(cam0.from_) + np.float32(TERRAIN_MOVE), at=cam0.at, up=cam0.up,
                       cos_fovy=cam0.cos_fovy)
    rt.set_camera(cam1)
    _require(bool(np.array_equal(rt.baked_tab.origin, np.float32(cam1.from_))), "set_camera did not rebake")
    prim_1 = first_frame_primaries(rt, ck.pixel_order(TERRAIN_RES, TERRAIN_RES, dev))
    b3k["camera 0 moved"] = _check_baked(torch, ct, cluster, tb, prim_1, rt.baked_tab,
                                         f"terrain primary 1024^2, camera 0 moved by {TERRAIN_MOVE}")
    rt.set_camera(cam0)  # back, and baked again, before the main path of phase 8
    print(f"  bake_shared_origin_tab of the {tb.num_tris}-triangle table {tuple(tb.tri_tab.shape)}: {bake_ms:.4f} ms "
          f"(CUDA events), paid per camera move", flush=True)
    del prim_1
    del bounce, shadow, ob, db, teb, os_, ds_, tes, si_p, u

    # the walks on a scene that needs two rounds of supercluster boxes per ray
    with tempfile.TemporaryDirectory() as tmp:
        big = Renderer(parse_scene(write_terrain_scene(tmp, grid=ROUNDS_GRID, width=64, height=64)), width=64,
                       height=64, mode=RendererType.NORMALS, device=dev).bvh
    _require(big.sc_min.shape[0] > 256, f"the grid-{ROUNDS_GRID} terrain has only {big.sc_min.shape[0]} superclusters")
    o2, d2, tm2_c, tm2_a = bounce_like_rays(big, ROUNDS_RAYS, dev, SEED)
    rays2 = Ray(origin=o2, direction=d2)
    args2 = (big.tri_tab, big.cluster_min, big.cluster_max, big.sc_min, big.sc_max, o2, d2)
    big_sc = (big.sc_min, big.sc_max)
    keys2 = cluster.cold_start_keys(cluster.ray_t_bounds(big.cluster_min, big.cluster_max, rays2, tm2_c,
                                                         sc_boxes=big_sc))
    t_any2 = cluster.ray_t_bounds(big.cluster_min, big.cluster_max, rays2, tm2_a, sc_boxes=big_sc)
    key_k, cid_k = ct.trace_closest_walk_cuda(*args2, *keys2)
    key_q, cid_q = ct.trace_closest_walk_plain(*args2, *keys2)
    occ_k, occ_q = ct.trace_any_walk_cuda(*args2, t_any2), ct.trace_any_walk_plain(*args2, t_any2)
    torch.cuda.synchronize()
    cid_same = (cid_k == cid_q).float().mean().item()
    _require(bool((key_k == key_q).all()) and cid_same >= CID_EQUAL_MIN and bool((occ_k == occ_q).all()),
             f"walks on {big.sc_min.shape[0]} superclusters: key equal {(key_k == key_q).float().mean().item():.7f}, "
             f"cid {cid_same:.7f}, occlusion {(occ_k == occ_q).float().mean().item():.7f}")
    print(f"  walks on a {big.num_tris}-triangle terrain ({big.num_clusters} clusters, {big.sc_min.shape[0]} "
          f"superclusters: two rounds of level 1), {ROUNDS_RAYS} bounce-like rays: B3 key equal to the plain version's "
          f"on every lane, cid on {cid_same:.7f} ({int((cid_q >= 0).sum().item())} hits); B4 equal on every lane "
          f"({int(occ_q.sum().item())} occluded)", flush=True)
    del big, args2, rays2, o2, d2, key_k, cid_k, key_q, cid_q, occ_k, occ_q
    del key0, cid0, key_p, cid_p, lp, to_light, ldir, org_b, d_b
    # K4 on SPD's tetra (1,048,576 triangles, the benchmark's scene) and the textured gallery
    for label, path, res in (("tetra 1024^2", TETRA_SCENE, TERRAIN_RES), ("gallery 512^2", GALLERY_SCENE,
                                                                         GALLERY_RES)):
        rk = Renderer(parse_scene(path), width=res, height=res, mode=RendererType.PATH, path_depth=MAIN_DEPTH,
                      device=dev)
        _require(rk.bvh.clustered and (rk.device_scene.has_textures == label.startswith("gallery")),
                 f"{label}: clustered {rk.bvh.clustered}, textures {rk.device_scene.has_textures}")
        for batch, v in _cluster_shade_scene(torch, sk, shade, ct, cm, bsdf, Ray, graph_ms, rk, smi, label).items():
            k4[f"{label.split()[0]} {batch}"] = v
        del rk
    # RATIO's 4M-ray visibility batch on the benchmark's tetra3 scene, unsorted, as the cell's frames trace it
    r3 = Renderer(parse_scene(TETRA3_SCENE), width=TERRAIN_RES, height=TERRAIN_RES, mode=RendererType.RATIO,
                  ratio_samples=TETRA3_SAMPLES, device=dev)
    _require(r3.bvh.clustered and r3.device_scene.num_lights == 6,
             f"tetra3: clustered {r3.bvh.clustered}, {r3.device_scene.num_lights} light triangles")
    ratio_vis = _check_ratio_visibility(torch, cluster, ct, r3, _frame_impl, reset_counts, launch_counts)
    del r3
    phase_done("phase 3")

    # ---- 4. the slice against the committed goldens ------------------------
    goldens = {"mask": RendererType.MASK, "normal": RendererType.NORMALS,
               "position": RendererType.POSITION, "diffuse": RendererType.DIFFUSE,
               "alpha": RendererType.ALPHA, "ltc_direct": RendererType.LTC_BASELINE,
               "path": RendererType.PATH}
    rmse = {}
    with tempfile.TemporaryDirectory() as tmp:
        gscene = parse_scene(write_cornell_scene(tmp, width=GOLDEN_RES, height=GOLDEN_RES))
        for name, mode in goldens.items():
            g = Renderer(gscene, width=GOLDEN_RES, height=GOLDEN_RES, mode=mode,
                         path_depth=GOLDEN_DEPTH, device=dev)
            g.render(GOLDEN_PATH_SPP if mode == RendererType.PATH else 1)
            want = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npy"))
            got = g.image()
            _require(got.shape == want.shape, f"golden {name}: shape {got.shape} != {want.shape}")
            rmse[name] = _golden_rmse(got, want)
            tol = 5e-3 if name == "path" else 1e-4
            _require(rmse[name] < tol, f"golden {name}: relative RMSE {rmse[name]:.3g} >= {tol}")
        ratio = {}
        for device in (dev, "cpu"):
            g = Renderer(gscene, width=GOLDEN_RES, height=GOLDEN_RES, mode=RendererType.RATIO,
                         ratio_samples=RATIO_SAMPLES, device=device)
            g.render(GOLDEN_RATIO_FRAMES)
            ratio[str(device)] = {"image": g.image(), **{k: v.cpu().numpy() for k, v in g.aux.items()}}
        card, host = ratio[str(dev)], ratio["cpu"]
        ratio_rmse = {k: _golden_rmse(card[k], host[k]) for k in host}
        for k, err in ratio_rmse.items():
            tol = 5e-3 if k.startswith("sto") else 1e-4
            _require(err < tol, f"RATIO card vs cpu {k}: relative RMSE {err:.3g} >= {tol}")
    gallery = parse_scene(os.path.join(ROOT, "scenes", "gallery", "scene.json"))
    for name, (mode, spp) in GALLERY_GOLDENS.items():
        g = Renderer(gallery, width=GOLDEN_RES, height=GOLDEN_RES, mode=RendererType[mode],
                     path_depth=GOLDEN_DEPTH, device=dev)
        _require(g.bvh.clustered, "the gallery does not take the cluster tier")
        reset_counts()
        g.render(spp)
        got = launch_counts()
        bounces = spp * GOLDEN_DEPTH if mode == "PATH" else 0
        want = (spp, bounces, spp + 2 * bounces)  # a sweep a trace: the primaries, each bounce's two
        _require((got["cluster_closest_walk_baked"], got["cluster_closest_walk"], got["sc_sweep"]) == want,
                 f"golden {name}: baked and unbaked walk and K-sweep launches {got['cluster_closest_walk_baked']}, "
                 f"{got['cluster_closest_walk']}, {got['sc_sweep']}, expected {want}")
        want = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npy"))
        got = g.image()
        _require(got.shape == want.shape, f"golden {name}: shape {got.shape} != {want.shape}")
        rmse[name] = _golden_rmse(got, want)
        tol = 5e-3 if mode == "PATH" else 1e-4
        _require(rmse[name] < tol, f"golden {name}: relative RMSE {rmse[name]:.3g} >= {tol}")
    # the terrain at 64^2: the card against the port's plain versions on the CPU
    terrain_rmse = {}
    for mode, tol in ((RendererType.NORMALS, 1e-4), (RendererType.PATH, 5e-3)):
        imgs = []
        for device in (dev, "cpu"):
            g = Renderer(terrain, width=GOLDEN_RES, height=GOLDEN_RES, mode=mode, path_depth=GOLDEN_DEPTH,
                         device=device)
            reset_counts()
            g.render(1)
            imgs.append(g.image())
            baked, sweeps = launch_counts()["cluster_closest_walk_baked"], launch_counts()["sc_sweep"]
            on_card = device == dev
            want_sweeps = (1 + (2 * GOLDEN_DEPTH if mode == RendererType.PATH else 0)) if on_card else 0
            _require(baked == int(on_card) and sweeps == want_sweeps and (g.baked_tab is None) == (not on_card),
                     f"terrain {mode.name} on {device}: {baked} baked walk and {sweeps} K-sweep launches, table "
                     f"{g.baked_tab is not None}")
        terrain_rmse[mode.name] = _golden_rmse(*imgs)
        _require(terrain_rmse[mode.name] < tol,
                 f"terrain {mode.name} card vs cpu: relative RMSE {terrain_rmse[mode.name]:.3g} >= {tol}")
    del g
    print("[4 goldens] relative RMSE vs tests/goldens (tol 1e-4, path 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in rmse.items())
          + f"; RATIO {GOLDEN_RES}^2 x {GOLDEN_RATIO_FRAMES} frames, card vs cpu (tol 1e-4, sto 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in ratio_rmse.items())
          + f"; terrain {GOLDEN_RES}^2 depth {GOLDEN_DEPTH} card vs cpu (NORMALS 1e-4, PATH 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in terrain_rmse.items()), flush=True)
    phase_done("phase 4")

    # ---- 5. main path PATH at full size -------------------------------------
    syncs = _no_implicit_syncs(torch, lambda: r.render(WARMUP_FRAMES))
    _require(not syncs, f"the PATH render loop synchronizes with the card at {syncs}")
    m0 = dict(r.metrics)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    r.render(TIMED_FRAMES)
    launches_path = launch_counts()
    m1 = dict(r.metrics)
    img = r.image()
    _require(img.shape == (MAIN_RES, MAIN_RES, 3), f"image shape {img.shape}")
    _require(bool(np.isfinite(img).all()), "image has non-finite values")
    _require(float(img.mean()) > 0.0, "image is black")
    want = expected(camera_rng=TIMED_FRAMES, brute_closest=TIMED_FRAMES * (1 + MAIN_DEPTH),
                    brute_any=TIMED_FRAMES * MAIN_DEPTH, brute_shade=TIMED_FRAMES * (1 + MAIN_DEPTH),
                    path_sample=TIMED_FRAMES * MAIN_DEPTH, path_combine=TIMED_FRAMES * MAIN_DEPTH)
    _require(launches_path == want, f"PATH launch counts {launches_path}, expected {want}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    # the share of lanes with t_max > 0 in each launch of the last frame: B1 traces the primaries (every
    # lane) and each bounce's valid BSDF samples, B2 each bounce's needed NEE shadow rays
    per_bounce = r.aux["path_alive_counts"].cpu().numpy() / n_px
    live_b1 = [1.0] + [float(x) for x in per_bounce[:, 2]]
    live_b2 = [float(x) for x in per_bounce[:, 1]]
    print(f"  live lanes (t_max > 0) per launch of the last frame: B1 primary then bounces "
          f"{[round(x, 4) for x in live_b1]}, B2 bounces {[round(x, 4) for x in live_b2]}", flush=True)
    print(f"[5 main path] PATH depth {MAIN_DEPTH} Cornell {MAIN_RES}^2, {TIMED_FRAMES} frames after "
          f"{WARMUP_FRAMES} warm-up: {secs / TIMED_FRAMES * 1e3:.3f} ms/frame, "
          f"{rays / secs / 1e6:.3f} Mrays/s honest ({rays} rays), image mean {img.mean():.5f}, "
          f"peak {peak_gib:.3f} GiB, launches {launches_path}, implicit syncs in {WARMUP_FRAMES} warm-up frames: "
          f"{len(syncs)}, on {smi}", flush=True)
    del r
    phase_done("phase 5")

    # ---- 6. main path LTC_BASELINE at full size -----------------------------
    warm_up(rl, cornell.cameras[0])  # the key's eager frame, then the capture
    reset_counts()
    secs = 0.0
    for _ in range(TIMED_FRAMES):
        rl.set_camera(cornell.cameras[0])  # a deterministic mode renders one frame per accumulation
        s0 = rl.metrics["seconds"]
        rl.render(1)
        secs += rl.metrics["seconds"] - s0
    launches_ltc = launch_counts()
    want = expected(camera_rng=TIMED_FRAMES, brute_closest=TIMED_FRAMES, ltc=TIMED_FRAMES, brute_shade=TIMED_FRAMES)
    _require(launches_ltc == want, f"LTC_BASELINE launch counts {launches_ltc}, expected {want}")
    img = rl.image()
    _require(img.shape == (MAIN_RES, MAIN_RES, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
             f"LTC_BASELINE image: shape {img.shape}, mean {img.mean()}")
    # the LTC term of a frame is one launch of B6 and nothing else: no setup op runs on the card (one eager
    # _frame_impl frame, the frame the graph captured, profiled: the integrator's span ltc.direct is
    # profile_frames' stage ltc); a replayed frame leaves the state it started from as it was (a pure
    # function of the state, as in JAX) and equals the eager frame
    rl.set_camera(cornell.cameras[0])
    state0 = rl.state
    accum0 = state0.accum.clone()
    # the profiled frame is the second of two sessions: the first profiler session after phases without one
    # recorded no device operation of this frame (16 operations since K0), while the next one recorded all of
    # them on an H100
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            want_state, _frames = eager_frames(rl, state0, 1)
            torch.cuda.synchronize()
    rl.render(1)
    _require(rl.state.accum is not state0.accum and bool(torch.equal(state0.accum, accum0))
             and state0.accum_id == 0 and rl.state.accum_id == 1, "the LTC frame changed the state it started from")
    _require(bool(torch.equal(rl.state.accum, want_state.accum)), "the replayed LTC frame differs from the eager one")
    ltc_prof = device_breakdown(prof, 1)
    ltc_stages = ltc_prof["stages"]
    _require(ltc_stages["ltc"]["calls_per_frame"] == 1 and ltc_stages["B6"]["calls_per_frame"] == 1
             and ltc_stages["ltc"]["device_ms_per_frame"] == 0.0,
             f"the LTC term of a frame: {ltc_stages['ltc']} outside B6 ({ltc_stages['B6']}), expected B6 alone; "
             f"the profile held {ltc_prof['kernels_per_frame']} device operations: "
             f"{ltc_prof['top_kernels_ms_per_frame']}")
    print(f"[6 main path] LTC_BASELINE Cornell {MAIN_RES}^2, {TIMED_FRAMES} single frames (replays) after 2 warm-up: "
          f"{secs / TIMED_FRAMES * 1e3:.3f} ms/frame, {TIMED_FRAMES * n_px / secs / 1e6:.3f} Mrays/s "
          f"(primary rays), image mean {img.mean():.5f}, launches {launches_ltc}; an eager frame's LTC term, "
          f"profiled: B6 {ltc_stages['B6']['device_ms_per_frame']:.4f} ms, no other kernel; a replayed frame "
          f"equal to it, its input state unchanged, on {smi}", flush=True)
    del rl, ltc_l2
    phase_done("phase 6")

    # ---- 7. main path RATIO at full size, then denoise and combine ---------
    syncs = _no_implicit_syncs(torch, lambda: rr.render(WARMUP_FRAMES))
    _require(not syncs, f"the RATIO render loop synchronizes with the card at {syncs}")
    m0 = dict(rr.metrics)
    reset_counts()
    rr.render(TIMED_FRAMES)
    launches_ratio = launch_counts()
    m1 = dict(rr.metrics)
    want = expected(camera_rng=TIMED_FRAMES, brute_closest=TIMED_FRAMES, brute_any=TIMED_FRAMES, ltc=TIMED_FRAMES,
                    brute_shade=TIMED_FRAMES)
    _require(launches_ratio == want, f"RATIO launch counts {launches_ratio}, expected {want}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    _require(rays == TIMED_FRAMES * n_px * (1 + RATIO_SAMPLES), f"RATIO counted {rays} rays")
    aux = rr.aux
    post = lambda: denoise_and_combine(aux, rr.gbuffers)  # noqa: E731  (the CLI's --denoise-ratio stage)
    final = post()
    post_ms = _time_ms(torch, post, 5)
    ltc_img, d_img, n_img = (aux[k].cpu().numpy() for k in ("ltc", "sto_direct", "sto_no_vis"))
    final = final.cpu().numpy()
    for name, a in (("ltc", ltc_img), ("sto_direct", d_img), ("sto_no_vis", n_img), ("ratio_final", final)):
        _require(bool(np.isfinite(a).all()), f"RATIO {name} has non-finite values")
    _require(bool((n_img - d_img >= -1e-5).all()), "RATIO: sto_no_vis < sto_direct somewhere")
    _require(d_img.max() > 0.01 and n_img.max() > 0.01, "RATIO: black stochastic buffers")
    _require(bool((final >= 0).all()) and bool((final <= ltc_img * 1.35 + 0.05).all()),
             "RATIO: ratio_final outside [0, ltc * 1.35 + 0.05]")
    lit = ltc_img.sum(-1) > 0.05
    shadowed, unshadowed = final.sum(-1)[lit].mean(), ltc_img.sum(-1)[lit].mean()
    _require(shadowed < unshadowed, f"RATIO: ratio_final mean {shadowed} is not below the LTC mean {unshadowed}")
    print(f"[7 main path] RATIO Cornell-3 {MAIN_RES}^2, {RATIO_SAMPLES} shadow samples, {TIMED_FRAMES} frames "
          f"after {WARMUP_FRAMES} warm-up: {secs / TIMED_FRAMES * 1e3:.3f} ms/frame, "
          f"{rays / secs / 1e6:.3f} Mrays/s (primary + shadow, {rays} rays), launches {launches_ratio}, "
          f"implicit syncs in {WARMUP_FRAMES} warm-up frames: {len(syncs)}; denoise x2 + ratio_combine "
          f"{post_ms:.3f} ms (CUDA events), ratio_final mean {shadowed:.5f} vs LTC {unshadowed:.5f} on lit "
          f"pixels, on {smi}", flush=True)
    del rr, aux
    phase_done("phase 7")

    # ---- 8. main path config 5: terrain NORMALS at 1024^2 -------------------
    # warm-up: the key's eager frame, then (after set_camera, whose host-to-card copies of the camera are not a
    # frame's) the capture and a replay
    syncs = _no_implicit_syncs(torch, lambda: rt.render(1))
    rt.set_camera(terrain.cameras[0])
    syncs += _no_implicit_syncs(torch, lambda: rt.render(1))
    _require(not syncs, f"the terrain NORMALS frame synchronizes with the card at {syncs}")
    m0 = dict(rt.metrics)
    reset_counts()
    secs = 0.0
    for _ in range(TERRAIN_FRAMES):
        rt.set_camera(terrain.cameras[0])  # a deterministic mode renders one frame per accumulation
        s0 = rt.metrics["seconds"]
        rt.render(1)
        secs += rt.metrics["seconds"] - s0
    launches_c5 = launch_counts()
    want = expected(camera_rng=TERRAIN_FRAMES, cluster_closest_walk_baked=TERRAIN_FRAMES, cluster_shade=TERRAIN_FRAMES,
                    sc_sweep=TERRAIN_FRAMES)
    _require(launches_c5 == want, f"config 5 launch counts {launches_c5}, expected {want}")
    img = rt.image()
    _require(img.shape == (TERRAIN_RES, TERRAIN_RES, 3) and bool(np.isfinite(img).all())
             and float(np.abs(img).mean()) > 0.0,  # normals: signed components
             f"terrain NORMALS image: shape {img.shape}, mean |value| {np.abs(img).mean()}")
    print(f"[8 main path] config 5: terrain NORMALS {TERRAIN_RES}^2 ({tb.num_tris} triangles), {TERRAIN_FRAMES} "
          f"single frames (replays) after 2 warm-up: {secs / TERRAIN_FRAMES * 1e3:.3f} ms/frame, "
          f"{TERRAIN_FRAMES * n_t / secs / 1e6:.3f} Mrays/s (primary rays), image mean {img.mean():.5f}, "
          f"launches {launches_c5}, host syncs in the warm-up frames: {len(syncs)}, "
          f"on {smi}", flush=True)
    phase_done("phase 8")

    # ---- 9. main path config 6: gallery PATH depth 4 at 512^2 ---------------
    rg = Renderer(gallery, width=GALLERY_RES, height=GALLERY_RES, mode=RendererType.PATH, path_depth=MAIN_DEPTH,
                  device=dev)
    syncs = _no_implicit_syncs(torch, lambda: rg.render(WARMUP_FRAMES))
    _require(not syncs, f"the gallery PATH render loop synchronizes with the card at {syncs}")
    m0 = dict(rg.metrics)
    reset_counts()
    rg.render(TIMED_FRAMES)
    launches_c6 = launch_counts()
    m1 = dict(rg.metrics)
    traces = TIMED_FRAMES * (1 + MAIN_DEPTH)
    want = expected(camera_rng=TIMED_FRAMES, cluster_closest_walk_baked=TIMED_FRAMES,
                    cluster_closest_walk=TIMED_FRAMES * MAIN_DEPTH,
                    cluster_any_walk=TIMED_FRAMES * MAIN_DEPTH, cluster_shade=traces,
                    path_sample=TIMED_FRAMES * MAIN_DEPTH, path_combine=TIMED_FRAMES * MAIN_DEPTH,
                    sc_sweep=TIMED_FRAMES * (1 + 2 * MAIN_DEPTH))
    _require(launches_c6 == want, f"config 6 launch counts {launches_c6}, expected {want}")
    img = rg.image()
    _require(img.shape == (GALLERY_RES, GALLERY_RES, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
             f"gallery PATH image: shape {img.shape}, mean {img.mean()}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    print(f"[9 main path] config 6: gallery PATH depth {MAIN_DEPTH} {GALLERY_RES}^2 ({rg.bvh.num_tris} triangles, "
          f"{rg.bvh.num_clusters} clusters), {TIMED_FRAMES} frames after {WARMUP_FRAMES} warm-up: "
          f"{secs / TIMED_FRAMES * 1e3:.3f} ms/frame, {rays / secs / 1e6:.3f} Mrays/s honest ({rays} rays), "
          f"image mean {img.mean():.5f}, launches {launches_c6}, implicit syncs in "
          f"{WARMUP_FRAMES} warm-up frames: {len(syncs)}, on {smi}", flush=True)
    del rg
    phase_done("phase 9")

    # ---- 10. main path config 5b: terrain PATH depth 4 at 1024^2 ------------
    rt.set_mode(RendererType.PATH)
    traces = 1 + 2 * MAIN_DEPTH  # primary, then NEE and bounce per bounce
    syncs = _no_implicit_syncs(torch, lambda: rt.render(WARMUP_FRAMES))  # warm-up, the frame graph's capture too
    # the walks cut nothing and ask the host nothing
    _require(not syncs, f"the terrain PATH frame synchronizes with the card at {syncs}")
    m0 = dict(rt.metrics)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    rt.render(TERRAIN_PATH_FRAMES)
    launches_c5b = launch_counts()
    m1 = dict(rt.metrics)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n_fr = TERRAIN_PATH_FRAMES
    want = expected(camera_rng=n_fr, cluster_closest_walk_baked=n_fr, cluster_closest_walk=n_fr * MAIN_DEPTH,
                    cluster_any_walk=n_fr * MAIN_DEPTH, cluster_shade=n_fr * (1 + MAIN_DEPTH),
                    path_sample=n_fr * MAIN_DEPTH, path_combine=n_fr * MAIN_DEPTH, sc_sweep=n_fr * traces)
    _require(launches_c5b == want, f"config 5b launch counts {launches_c5b}, expected {want}")
    img = rt.image()
    _require(img.shape == (TERRAIN_RES, TERRAIN_RES, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
             f"terrain PATH image: shape {img.shape}, mean {img.mean()}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    print(f"[10 main path] config 5b: terrain PATH depth {MAIN_DEPTH} {TERRAIN_RES}^2, {n_fr} frames after "
          f"{WARMUP_FRAMES} warm-up: {secs / n_fr * 1e3:.3f} ms/frame, {rays / secs / 1e6:.3f} Mrays/s honest ({rays} rays), "
          f"image mean {img.mean():.5f}, peak {peak_gib:.3f} GiB, launches {launches_c5b}, "
          f"host syncs in the warm-up frames: {len(syncs)} ({traces} trace calls a frame), on {smi}", flush=True)
    phase_done("phase 10")
    del rt

    # ---- 11. the CLI on the card: a moved camera, its outputs, its checkpoint resumed --------
    gallery_path = os.path.join(ROOT, "scenes", "gallery", "scene.json")
    with tempfile.TemporaryDirectory() as out:
        ckpt = os.path.join(out, "resume.npz")
        cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", gallery_path,
               "--renderer", "path", "--spp", str(CLI_SPP), "--depth", str(MAIN_DEPTH), "--res", str(CLI_RES),
               "--cam-from", *(str(x) for x in CLI_CAM_FROM), "--save-gbuffers", "--save-exr",
               "--save-checkpoint", ckpt, "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        _require(proc.returncode == 0, f"the CLI failed ({proc.returncode}): {proc.stderr[-3000:]}")
        files = sorted(os.listdir(out))
        want_files = {"path.png", "path.exr", "render.json", "resume.npz"} | {
            f"gbuffer_{f}.{ext}" for f in ("position", "normal", "albedo", "alpha", "material_id")
            for ext in ("png", "exr")}
        _require(want_files <= set(files), f"the CLI wrote {files}, missing {sorted(want_files - set(files))}")
        with open(os.path.join(out, "render.json")) as f:
            manifest = json.load(f)
        _require(manifest["spp"] == CLI_SPP and manifest["device"] == kind, f"the CLI's manifest: {manifest}")
        rc = Renderer(gallery, width=CLI_RES, height=CLI_RES, mode=RendererType.PATH, path_depth=MAIN_DEPTH,
                      device=dev)
        origin0 = rc.baked_tab.origin.copy()
        rc.load_checkpoint(ckpt)
        moved = np.float32(CLI_CAM_FROM)
        _require(bool(np.array_equal(rc.baked_tab.origin, moved)) and not np.array_equal(origin0, moved),
                 f"the resumed Renderer's table has the origin {rc.baked_tab.origin}, not the checkpoint's {moved}")
        _require(bool(torch.equal(rc.baked_tab.tab, cluster.bake_shared_origin_tab(rc.bvh.tri_tab, moved).tab)),
                 "the resumed Renderer's table is not the bake of the checkpoint's origin")
        reset_counts()
        rc.render(1)
        resumed = launch_counts()
        img = rc.image()
        _require(rc.state.accum_id == CLI_SPP + 1 and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0
                 and resumed["cluster_closest_walk_baked"] == 1 and resumed["sc_sweep"] == 1 + 2 * MAIN_DEPTH,
                 f"the resumed render: accum_id {rc.state.accum_id}, mean {img.mean()}, launches {resumed}")
    print(f"[11 CLI] gallery PATH depth {MAIN_DEPTH} {CLI_RES}^2, {CLI_SPP} spp from --cam-from {list(CLI_CAM_FROM)}: "
          f"{cli_s:.1f} s for the process; wrote {len(files)} files ({', '.join(files)}); the checkpoint resumed "
          f"in a Renderer built at camera 0 rebaked its table at {rc.baked_tab.origin.tolist()} and rendered frame "
          f"{rc.state.accum_id} through the baked walk", flush=True)
    del rc
    phase_done("phase 11")

    from optix_renderer_tpu_torch.accel.build import build_bvh_cached
    from optix_renderer_tpu_torch.engine.renderer import bvh_inputs
    from optix_renderer_tpu_torch.engine.serve import ViewerServer
    from optix_renderer_tpu_torch.parallel import sharding
    from optix_renderer_tpu_torch.scene.device import build_device_scene

    with tempfile.TemporaryDirectory() as surf:  # the terrain's files for the viewer's record op and the CLI
        # ---- 12. the multi-device split on the card: SPLIT_DEVICES shares of the one card ----------
        # every tile a replay of its own graph (one per row range) once the warm-up captured them
        pair = [dev] * SPLIT_DEVICES
        one, split = (Renderer(cornell, width=MAIN_RES, height=MAIN_RES, mode=RendererType.PATH,
                               path_depth=MAIN_DEPTH, device=dev) for _ in range(2))
        one.render(WARMUP_FRAMES)  # warm-up, the same frames on both sides (and their graphs' captures)
        n_cap = len(captures)
        syncs = _no_implicit_syncs(torch, lambda: sharding.render_rows(split, pair, WARMUP_FRAMES))
        _require(not syncs, f"a row-split PATH frame synchronizes with the card at {syncs}")
        _require(len(captures) == n_cap + SPLIT_DEVICES, f"the row split captured {len(captures) - n_cap} graphs")
        m0 = {"one": dict(one.metrics), "split": dict(split.metrics)}
        reset_counts()
        want_split, frames = eager_frames(split, split.state, SPLIT_FRAMES)
        launches_eager = launch_counts()
        reset_counts()
        one.render(SPLIT_FRAMES)
        reset_counts()
        sharding.render_rows(split, pair, SPLIT_FRAMES)
        launches_split = launch_counts()
        m1 = {"one": dict(one.metrics), "split": dict(split.metrics)}
        want = expected(camera_rng=SPLIT_DEVICES * SPLIT_FRAMES,
                        brute_closest=SPLIT_DEVICES * SPLIT_FRAMES * (1 + MAIN_DEPTH),
                        brute_any=SPLIT_DEVICES * SPLIT_FRAMES * MAIN_DEPTH,
                        brute_shade=SPLIT_DEVICES * SPLIT_FRAMES * (1 + MAIN_DEPTH),
                        path_sample=SPLIT_DEVICES * SPLIT_FRAMES * MAIN_DEPTH,
                        path_combine=SPLIT_DEVICES * SPLIT_FRAMES * MAIN_DEPTH)
        _require(launches_split == want and {k: v * SPLIT_DEVICES for k, v in launches_eager.items()} == want,
                 f"row-split PATH launch counts {launches_split}, eager {launches_eager}, expected {want}")
        _require(split.state.accum_id == one.state.accum_id == SPLIT_FRAMES + WARMUP_FRAMES
                 and bool(torch.equal(split.state.accum, one.state.accum)),
                 "the row-split PATH frames differ from the single-device frames")
        same_frames("row-split PATH", split.state, split.gbuffers, split.aux, want_split, frames)
        rays_e, alive_e = eager_rays(split, frames)
        _require(m1["split"]["rays_traced"] == m1["one"]["rays_traced"]
                 and m1["split"]["rays_traced"] - m0["split"]["rays_traced"] == rays_e
                 and m1["split"]["alive_per_bounce"] == m1["one"]["alive_per_bounce"] == alive_e,
                 f"honest rays: split {m1['split']['rays_traced']}, single {m1['one']['rays_traced']}, "
                 f"eager {rays_e} more")
        _require(len(captures) == n_cap + SPLIT_DEVICES, "the row split captured again")
        ms_path = {k: (m1[k]["seconds"] - m0[k]["seconds"]) / SPLIT_FRAMES * 1e3 for k in m1}
        del one, split, frames, want_split
        # the spp split: SPLIT_DEVICES frames in one step (a whole-frame graph a share), against as many eager
        # frames; the first step runs each share's eager frame, the second captures, the third only replays
        rs = Renderer(cornell, width=MAIN_RES, height=MAIN_RES, mode=RendererType.PATH, path_depth=MAIN_DEPTH,
                      device=dev)
        step = sharding.make_spp_sharded_frame_fn(pair, RendererType.PATH, MAIN_RES, MAIN_RES, path_depth=MAIN_DEPTH)
        reps = [sharding.replicate(x, pair) for x in (rs.device_scene, rs.bvh, rs.baked_tab)]
        step(rs.state, *reps)
        step(rs.state, *reps)
        reset_counts()
        want_spp, frames = eager_frames(rs, rs.state, SPLIT_DEVICES, every_gbuffer=True)
        launches_eager = launch_counts()
        out = []
        reset_counts()
        syncs_spp = _no_implicit_syncs(torch, lambda: out.append(step(rs.state, *reps)))
        torch.cuda.synchronize(dev)
        launches_spp = launch_counts()
        _require(not syncs_spp, f"the spp split synchronizes with the card at {syncs_spp}")
        _require(launches_spp == launches_eager, f"spp split launches {launches_spp}, eager {launches_eager}")
        _require(out[0][0].accum_id == SPLIT_DEVICES and bool(torch.equal(out[0][0].accum, want_spp.accum)),
                 "the spp split differs from the sequential frames")
        for (gb, aux), g, a in zip(frames, out[0][1], out[0][2]):
            _require(all(bool(torch.equal(getattr(g, f.name), getattr(gb, f.name))) for f in dataclasses.fields(gb))
                     and bool(torch.equal(a["path_alive_counts"], aux["path_alive_counts"])),
                     "an spp share's g-buffers or per-bounce counts differ from its eager frame's")
        del rs, out, reps, step, frames, want_spp
        # config 5's terrain NORMALS through the row split: every tile's primaries through the baked walk
        terrain_json = write_terrain_scene(surf, grid=TERRAIN_GRID, width=TERRAIN_RES, height=TERRAIN_RES)
        rv = Renderer(terrain, width=TERRAIN_RES, height=TERRAIN_RES, mode=RendererType.NORMALS,
                      path_depth=MAIN_DEPTH, device=dev)
        warm_up(rv, terrain.cameras[0])
        secs_t = {"one": [], "split": []}
        for _ in range(SPLIT_FRAMES):
            rv.set_camera(terrain.cameras[0])  # a deterministic mode renders one frame per accumulation
            s0 = rv.metrics["seconds"]
            rv.render(1)
            secs_t["one"].append(rv.metrics["seconds"] - s0)
        single_t = rv.state.accum
        rv.set_camera(terrain.cameras[0])
        want_t, _frames = eager_frames(rv, rv.state, 1)
        _require(bool(torch.equal(single_t, want_t.accum)), "the terrain frame differs from the eager frame")
        whole = weakref.ref(rv._frames.slots[0].graph)  # the whole frame's graph, captured by the warm-up
        syncs_t = _no_implicit_syncs(torch, lambda: sharding.render_rows(rv, pair, 1))  # each tile's eager frame
        gc.collect()
        _require(whole() is None, "the row split left the renderer's whole-frame graph alive beside its tiles'")
        _require(not syncs_t, f"a row-split terrain frame synchronizes with the card at {syncs_t}")
        _require(bool(torch.equal(rv.state.accum, single_t)), "the row-split terrain frame differs from the single")
        rv.set_camera(terrain.cameras[0])
        sharding.render_rows(rv, pair, 1)  # the tiles' captures
        reset_counts()
        for _ in range(SPLIT_FRAMES):
            rv.set_camera(terrain.cameras[0])
            s0 = rv.metrics["seconds"]
            sharding.render_rows(rv, pair, 1)
            secs_t["split"].append(rv.metrics["seconds"] - s0)
            _require(bool(torch.equal(rv.state.accum, single_t)), "a row-split terrain frame differs from the single")
        launches_split_t = launch_counts()
        want = expected(camera_rng=SPLIT_DEVICES * SPLIT_FRAMES,
                        cluster_closest_walk_baked=SPLIT_DEVICES * SPLIT_FRAMES,
                        cluster_shade=SPLIT_DEVICES * SPLIT_FRAMES, sc_sweep=SPLIT_DEVICES * SPLIT_FRAMES)
        _require(launches_split_t == want, f"row-split terrain launch counts {launches_split_t}, expected {want}")
        ms_t = {k: sum(v) / len(v) * 1e3 for k, v in secs_t.items()}
        print(f"[12 split] {SPLIT_DEVICES} shares of {dev}, each tile a replay of its own graph: Cornell PATH depth "
              f"{MAIN_DEPTH} {MAIN_RES}^2, {SPLIT_FRAMES} frames after {WARMUP_FRAMES} warm-up, bit-equal to one "
              f"device and to {SPLIT_FRAMES} eager frames with the same honest rays "
              f"({m1['split']['rays_traced']}): split {ms_path['split']:.3f} ms/frame, single "
              f"{ms_path['one']:.3f} ({ms_path['split'] / ms_path['one']:.3f}x), launches {launches_split}; spp split "
              f"of {SPLIT_DEVICES} frames in one step bit-equal to {SPLIT_DEVICES} eager frames, launches "
              f"{launches_spp}; config 5 terrain NORMALS {TERRAIN_RES}^2 ({rv.bvh.num_tris} triangles), "
              f"{SPLIT_FRAMES} split frames bit-equal to the single and the eager frame: split "
              f"{ms_t['split']:.3f} ms/frame, single {ms_t['one']:.3f} ({ms_t['split'] / ms_t['one']:.3f}x), "
              f"launches {launches_split_t}; implicit syncs in a split frame: {len(syncs)} (PATH), {len(syncs_t)} "
              f"(terrain), {len(syncs_spp)} (spp); on {smi}", flush=True)
        phase_done("phase 12")

        # ---- 13. the live viewer on the card: config 5b (terrain PATH depth 4 at 1024^2) --------
        rv.set_mode(RendererType.PATH)
        shots = os.path.join(surf, "shots")
        os.makedirs(shots)
        server = ViewerServer(rv, scene_path=terrain_json, port=0, out_dir=shots)
        held = rv.render_step_detached = _HeldFrame(rv.render_step_detached)
        reset_counts()
        server.start()
        try:
            port = server.port
            _wait_for(lambda: len(server.commits) >= 2, "the viewer's first two frames")
            # the first frame of the PATH key ran eagerly, the second captured its graph on the render thread
            viewer_caps = [c for c in captures if c["thread"] == "viewer-render"]
            _require(len(viewer_caps) == 1, f"captures on the viewer's render thread: {viewer_caps}")
            n_cap = len(captures)
            lat_status, lat_orbit, firsts, openers = [], [], [], []
            c0, t_rounds = len(server.commits), time.perf_counter()
            for k in range(VIEWER_ROUNDS):
                d0 = server.discarded
                held.arm()
                _wait_for(held.holding.is_set, f"a frame in flight before orbit {k}")
                try:
                    proc = subprocess.run([sys.executable, "-c", _VIEWER_CLIENT, str(port),
                                           str(VIEWER_STATUS_REQUESTS)],
                                          capture_output=True, text=True, timeout=VIEWER_DEADLINE_S)
                finally:
                    held.release()
                _require(proc.returncode == 0, f"viewer client round {k}: {proc.stderr[-2000:]}")
                got = json.loads(proc.stdout.strip().splitlines()[-1])
                lat_status += got["status_s"]
                lat_orbit.append(got["orbit_s"])
                openers.append(got["opener_s"])
                ans, st = got["orbit"], got["after"]
                epoch = ans["epoch"]
                _require(ans["ok"] and st["epoch"] == epoch and st["accum_id"] == 0,
                         f"orbit {k}: {ans}, then /status {st}")
                _wait_for(lambda: any(c[0] == epoch for c in list(server.commits)), f"a frame after orbit {k}")
                first = next(c for c in list(server.commits) if c[0] == epoch)
                moved = server.cam.as_scene_camera().from_
                _require(first[1] == 1, f"orbit {k}: the first committed frame has accum_id {first[1]}, not 1")
                firsts.append(first[2] * 1e3)  # the bake of the new origin runs on the stream just before it
                _require(bool(np.array_equal(rv.baked_tab.origin, moved)),
                         f"orbit {k}: the table's origin {rv.baked_tab.origin} is not the camera's {moved}")
                _require(server.discarded > d0, f"orbit {k}: no frame in flight was dropped")
                _require(len(captures) == n_cap, f"orbit {k}: the frame graph was captured again ({captures[n_cap:]})")
            fps = (len(server.commits) - c0) / (time.perf_counter() - t_rounds)
            frame_ms = statistics.median(c[2] for c in server.commits) * 1e3
            worst = max(lat_status + lat_orbit) * 1e3
            _require(worst < frame_ms / 3, f"a /status or /control answer took {worst:.3f} ms, more than a third "
                                           f"of the median committed frame ({frame_ms:.3f} ms); /status "
                                           f"{[round(x * 1e3, 2) for x in lat_status]} ms, orbit "
                                           f"{[round(x * 1e3, 2) for x in lat_orbit]} ms, in rounds of "
                                           f"{VIEWER_STATUS_REQUESTS} and 1")
            # mode switches: a deterministic mode stops at one frame; LTC_BASELINE runs B6
            stops = {}
            for mode in (RendererType.NORMALS, RendererType.LTC_BASELINE, RendererType.PATH):
                ltc0 = launch_counts()["ltc"]
                epoch = _http(port, "/control", {"op": "mode", "mode": int(mode)})[0]["epoch"]
                frames_of = lambda e=epoch: [c for c in list(server.commits) if c[0] == e]  # noqa: E731
                _wait_for(lambda: len(frames_of()) >= (2 if mode == RendererType.PATH else 1),
                          f"frames after the switch to {mode.name}")
                if mode != RendererType.PATH:
                    time.sleep(0.6)  # two of the idle loop's 0.25 s waits: no further frame may come
                    stops[mode.name] = len(frames_of())
                    _require(stops[mode.name] == 1 and _http(port, "/status")[0]["accum_id"] == 1,
                             f"{mode.name}: {stops[mode.name]} frames committed, expected 1")
                if mode == RendererType.LTC_BASELINE:
                    _require(launch_counts()["ltc"] > ltc0, "the viewer's LTC_BASELINE frame did not launch B6")
            shot = _http(port, "/control", {"op": "screenshot"})[0]
            with open(shot["path"], "rb") as f:
                _require(shot["ok"] and f.read(8) == b"\x89PNG\r\n\x1a\n", f"the screenshot {shot}")
            with open(terrain_json) as f:
                n_cams = len(json.load(f)["cameras"])
            _require(_http(port, "/control", {"op": "record"})[0]["ok"], "the record op failed")
            with open(terrain_json) as f:
                _require(len(json.load(f)["cameras"]) == n_cams + 1, "record did not append the camera")
            c1 = len(server.commits)
            _wait_for(lambda: len(server.commits) > c1, "a frame after the record op")
            png, png_s = _http(port, "/frame.png")  # a frame not encoded yet: the copy and the encode
            _require(png[:8] == b"\x89PNG\r\n\x1a\n", "/frame.png is not a PNG")
        finally:
            held.release()
            server.shutdown()
        del rv.render_step_detached
        launches_viewer = launch_counts()
        _require(server.error is None and not any(t.is_alive() for t in server._threads),
                 f"the viewer's render loop failed: {server.error!r}")
        for name in ("camera_rng", "cluster_closest_walk_baked", "cluster_closest_walk", "cluster_any_walk",
                     "cluster_shade", "ltc", "path_sample", "path_combine", "sc_sweep"):
            _require(launches_viewer[name] > 0, f"the viewer never launched {name}: {launches_viewer}")
        img = rv.image()
        _require(img.shape == (TERRAIN_RES, TERRAIN_RES, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0,
                 f"the viewer's final image: mean {img.mean()}")
        print(f"[13 viewer] config 5b terrain PATH depth {MAIN_DEPTH} {TERRAIN_RES}^2 behind a ViewerServer on port "
              f"{port}: {fps:.3f} committed frames/s over the {VIEWER_ROUNDS} rounds (each orbit drops the frame in "
              f"flight), median committed frame {frame_ms:.3f} ms, the first after each orbit (its bake included) "
              f"{[round(x, 3) for x in firsts]} ms; while frames were in flight, to a client process of its own, "
              f"/status answered in {statistics.median(lat_status) * 1e3:.3f} ms median, "
              f"{max(lat_status) * 1e3:.3f} max ({len(lat_status)} requests: "
              f"{[round(x * 1e3, 2) for x in lat_status]} ms), orbit in "
              f"{[round(x * 1e3, 3) for x in lat_orbit]} ms (bound a third of a frame, {frame_ms / 3:.3f} ms; each "
              f"client readied itself before its first request in {[round(x * 1e3, 3) for x in openers]} ms); "
              f"{server.discarded} frames dropped, each orbit's first frame accum_id 1 from a table rebaked at its "
              f"origin, no capture after an orbit (the PATH graph captured on the render thread in "
              f"{viewer_caps[0]['ms']:.3f} ms); NORMALS and LTC_BASELINE stopped at {stops} frame(s); /frame.png in {png_s * 1e3:.3f} ms; "
              f"{len(server.commits)} frames committed, image mean {img.mean():.5f}, launches {launches_viewer}, "
              f"on {smi}", flush=True)
        del server, rv
        phase_done("phase 13")

        # ---- 14. the BVH cache on the terrain: cold build, warm load, and the CLI twice --------------
        _ds, host = build_device_scene(terrain, dev)
        tv, bvh_kw = bvh_inputs(host)
        cache = os.path.join(surf, "bvh_cache")
        t0 = time.perf_counter()
        cold = build_bvh_cached(cache, tv, dev, **bvh_kw)
        torch.cuda.synchronize(dev)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = build_bvh_cached(cache, tv, dev, **bvh_kw)
        torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t0
        entries = os.listdir(cache)
        _require(len(entries) == 1 and entries[0].startswith("torch-bvh-"), f"cache entries {entries}")
        for f in dataclasses.fields(cold):
            _require(bool(torch.equal(getattr(cold, f.name), getattr(warm, f.name))),
                     f"the warm BVH's {f.name} differs from the cold build's")
        entry_mb = os.path.getsize(os.path.join(cache, entries[0])) / 2**20
        del _ds, host, cold, warm
        cli_cache, runs = os.path.join(surf, "cli_cache"), []
        for k in range(2):
            out_k = os.path.join(surf, f"cli{k}")
            cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", terrain_json,
                   "--renderer", "normals", "--res", str(CACHE_CLI_RES), "--bvh-cache", cli_cache, "--save-npy",
                   "--out", out_k]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            runs.append(time.perf_counter() - t0)
            _require(proc.returncode == 0, f"the CLI with --bvh-cache failed ({proc.returncode}): {proc.stderr[-3000:]}")
            said = [ln for ln in proc.stderr.splitlines() if "bvh cache:" in ln]
            _require(len(said) == 1 and ("built and wrote" if k == 0 else "loaded") in said[0],
                     f"CLI run {k} with --bvh-cache said {said}")
            runs.append(said[0].split("] ", 1)[-1])
        _require(len(os.listdir(cli_cache)) == 1, f"the CLI's cache holds {os.listdir(cli_cache)}")
        _require(bool(np.array_equal(np.load(os.path.join(surf, "cli0", "normals.npy")),
                                     np.load(os.path.join(surf, "cli1", "normals.npy")))),
                 "the CLI's image from the cached BVH differs from the built one")
        print(f"[14 BVH cache] terrain ({tv.shape[0]} triangles): cold build {cold_s:.3f} s, warm load "
              f"{warm_s:.3f} s (host seconds, upload included), one {entry_mb:.1f} MiB entry, every tensor equal; "
              f"the CLI with --bvh-cache (NORMALS {CACHE_CLI_RES}^2): {runs[0]:.1f} s for the process ({runs[1]}), "
              f"then {runs[2]:.1f} s ({runs[3]}), the same image", flush=True)
        del tv, bvh_kw
        phase_done("phase 14")

    # ---- 15. one dispatch for every frame: every frame a replay of its key's captured graph -------------
    def per_frame_ms(fn, n):
        """(host-clock ms, CUDA-event ms) per frame of ``fn``, which runs n frames."""
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, start.elapsed_time(end) / n

    def detached_on_side_stream(rend):
        """``rend.render_step_detached()`` on a stream of its own, as the viewer's render thread runs it:
        (the frame, where it synchronized), the frame done."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        out = []
        with torch.cuda.stream(side):
            syncs = _no_implicit_syncs(torch, lambda: out.append(rend.render_step_detached()))
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()
        return out[0], syncs

    def tensor_bytes(*trees):
        """Bytes of the distinct storages of the tensors in ``trees`` (dataclasses, dicts, tuples)."""
        seen = {}

        def walk(x):
            if isinstance(x, torch.Tensor):
                seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (tuple, list)):
                for v in x:
                    walk(v)
            elif dataclasses.is_dataclass(x) and not isinstance(x, type):
                for f in dataclasses.fields(x):
                    walk(getattr(x, f.name))

        walk(trees)
        return sum(seen.values())

    def pool_bytes(pool_id):
        """(reserved, allocated) bytes of the private memory pool ``pool_id``, from the allocator's segments;
        None where the snapshot does not name the segments' pools."""
        segments = torch.cuda.memory_snapshot()
        if not segments or "segment_pool_id" not in segments[0]:
            return None
        mine = [sg for sg in segments if tuple(sg["segment_pool_id"]) == tuple(pool_id)]
        return sum(sg["total_size"] for sg in mine), sum(sg["allocated_size"] for sg in mine)

    def settle_memory():
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)

    def eager_frame_memory(rend, state):
        """One eager frame from ``state`` with no slot alive, its allocations in a fresh private pool as a
        capture's are: (allocated bytes before it, its allocated peak above them, the pool's reserved bytes;
        None where this torch has no ``use_mem_pool``)."""
        base = settle_memory()
        if not hasattr(torch.cuda, "use_mem_pool"):
            eager_frames(rend, state, 1)
            torch.cuda.synchronize(dev)
            return base, torch.cuda.max_memory_allocated(dev) - base, None
        mp = torch.cuda.MemPool()
        with torch.cuda.use_mem_pool(mp):
            out = eager_frames(rend, state, 1)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        pool = pool_bytes(mp.id)
        del out, mp
        settle_memory()
        return base, peak, None if pool is None else pool[0]

    def graph_vs_eager(label, rend, cam, n):
        """``rend``'s frames through its graph against ``_frame_impl`` frames from one state: ``render(n)``
        (a deterministic mode: ``set_camera`` and one frame), a detached frame on a side stream, the
        eager frames and the replays in turns (a deterministic mode: n single frames each way), the
        capture's ms; then, the graph dropped, the eager frames themselves.  Memory, each side measured
        once: the graph's footprint is the allocated peak of ``render(n)`` with the graph alive (its
        outputs, the pool's allocated blocks, counted there once) plus its pool's reserved-but-free bytes;
        the eager side's, one eager frame's allocated peak with no slot alive, that frame's allocations made
        in a fresh private pool as the capture's were, so that the two pools' reserved bytes compare."""
        det = rend.mode in DETERMINISTIC_MODES
        n_cap = len(captures)
        warm_up(rend, cam)  # the key's eager frame, then the capture
        slot = rend._frames.slots[0]
        graph = slot.graph
        _require(len(captures) == n_cap + 1 and isinstance(graph, TimedGraph),
                 f"{label}: the warm-up captured {captures[n_cap:]}")
        if det:
            rend.set_camera(cam)  # a new accumulation: one frame
        n_run = 1 if det else n
        state0 = rend.state
        m0 = dict(rend.metrics)
        base_graph = settle_memory()
        reset_counts()
        syncs = _no_implicit_syncs(torch, lambda: rend.render(n_run))
        l_graph = launch_counts()
        peak_graph = torch.cuda.max_memory_allocated(dev)
        pool = pool_bytes(graph.graph.pool())
        static_bytes = tensor_bytes(slot.buf)  # the slot's buffers: accumulator, camera, table copy, sums
        out_bytes = tensor_bytes(graph.outputs)  # the graph's static outputs, in its pool
        m1 = dict(rend.metrics)
        _require(not syncs, f"{label}: render({n_run}) through the frame graph synchronizes with the card at {syncs}")
        _require(len(captures) == n_cap + 1 and rend._frames.slots[0].graph is graph,
                 f"{label}: render({n_run}) captured again")
        render_ms = (m1["seconds"] - m0["seconds"]) * 1e3 / n_run
        # a detached frame on a side stream: the eager frame from the published state, which stays as it was
        published = rend.state
        accum_before = published.accum.clone()
        want_d, frames_d = eager_frames(rend, published, 1)
        torch.cuda.synchronize(dev)
        reset_counts()
        frame_d, syncs_d = detached_on_side_stream(rend)
        l_detached = launch_counts()
        _require(not syncs_d, f"{label}: the detached frame synchronizes with the card at {syncs_d}")
        same_frames(f"{label} detached", frame_d[0], frame_d[1], frame_d[2], want_d, frames_d)
        _require(rend.state is published and bool(torch.equal(published.accum, accum_before))
                 and {k: v * n_run for k, v in l_detached.items()} == l_graph,
                 f"{label}: the detached frame changed the renderer, or launched {l_detached}")
        del frame_d, frames_d, want_d, accum_before
        if det:  # one frame per accumulation: k single frames each way, from the same state
            k = GRAPH_SINGLES
            run_graph = lambda: [slot.frames(state0, rend.baked_tab, 1) for _ in range(k)]  # noqa: E731
            run_eager = lambda: [eager_frames(rend, state0, 1) for _ in range(k)]  # noqa: E731
        else:
            k = n
            run_graph = lambda: slot.frames(state0, rend.baked_tab, k)  # noqa: E731
            run_eager = lambda: eager_frames(rend, state0, k)  # noqa: E731
        turns = {"eager": [], "graph": []}
        reset_counts()
        for side in ("eager", "graph", "graph", "eager"):
            turns[side].append(per_frame_ms(run_graph if side == "graph" else run_eager, k))
        # with no slot or graph alive: one eager frame's memory, then the eager frames from the same state
        rend._frames = None
        del slot, graph, run_graph, run_eager
        base_eager, frame_eager, frame_pool = eager_frame_memory(rend, state0)
        reset_counts()
        want, frames = eager_frames(rend, state0, n_run)
        torch.cuda.synchronize(dev)
        l_eager = launch_counts()
        same_frames(label, rend.state, rend.gbuffers, rend.aux, want, frames)
        _require(l_graph == l_eager and any(l_graph.values()),
                 f"{label}: launches through the graph {l_graph}, eager {l_eager}")
        rays, alive = eager_rays(rend, frames)
        _require(m1["rays_traced"] - m0["rays_traced"] == rays and m1["frames"] - m0["frames"] == len(frames),
                 f"{label}: honest rays {m1['rays_traced'] - m0['rays_traced']} through the graph, {rays} eager")
        _require(alive is None or m1["alive_per_bounce"] == alive, f"{label}: alive_per_bounce {m1['alive_per_bounce']}")
        reset_counts()  # the timed turns and the reference frames are not a main path's run
        cap_ms = captures[n_cap]["ms"]
        gib = 2.0 ** -30
        pool_free = None if pool is None else pool[0] - pool[1]
        mem = {"eager": (base_eager + frame_eager) * gib, "eager_base": base_eager * gib,
               "eager_frame": frame_eager * gib,
               "eager_frame_pool": None if frame_pool is None else frame_pool * gib,
               "graph": None if pool is None else (peak_graph + pool_free) * gib,
               "graph_allocated": peak_graph * gib, "graph_base": base_graph * gib,
               "pool_reserved": None if pool is None else pool[0] * gib,
               "pool_allocated": None if pool is None else pool[1] * gib,
               "pool_free": None if pool is None else pool_free * gib,
               "static_buffers": static_bytes * gib, "outputs": out_bytes * gib}
        if pool is not None:  # what the graph holds beyond one eager frame and the slot's buffers
            mem["gap"] = mem["graph"] - mem["eager"]
            mem["beyond_static"] = mem["gap"] - mem["static_buffers"]
            mem["pool_beyond_eager_frame"] = mem["pool_reserved"] - mem["eager_frame"]
            if frame_pool is not None:  # the allocator's rounding, and what a capture reserves beyond it
                mem["eager_pool_rounding"] = mem["eager_frame_pool"] - mem["eager_frame"]
                mem["capture_beyond_eager_pool"] = mem["pool_reserved"] - mem["eager_frame_pool"]
        out = {"frames": len(frames), "render_ms_per_frame": render_ms, "capture_ms": cap_ms,
               "eager_ms_per_frame": {"host": [t[0] for t in turns["eager"]], "events": [t[1] for t in turns["eager"]]},
               "graph_ms_per_frame": {"host": [t[0] for t in turns["graph"]], "events": [t[1] for t in turns["graph"]]},
               "memory_gib": mem, "rays": rays, "launches": l_graph}
        e, g = out["eager_ms_per_frame"], out["graph_ms_per_frame"]
        print(f"  {label}: {len(frames)} frame(s) bit-equal eager vs graph (accum, g-buffers, aux), honest rays "
              f"{rays}, launches {l_graph}, 0 implicit syncs; a detached frame on a side stream bit-equal, "
              f"the renderer unchanged; {'set_camera + render(1)' if det else f'render({n})'} {render_ms:.3f} "
              f"ms/frame; in turns of {k} frames eager, graph, graph, eager ms/frame host {e['host'][0]:.3f}, "
              f"{g['host'][0]:.3f}, {g['host'][1]:.3f}, {e['host'][1]:.3f}, CUDA events {e['events'][0]:.3f}, "
              f"{g['events'][0]:.3f}, {g['events'][1]:.3f}, {e['events'][1]:.3f}; capture {cap_ms:.3f} ms; memory GiB "
              + json.dumps({k: (None if v is None else round(v, 6)) for k, v in mem.items()}), flush=True)
        return out, [l_graph, l_detached]

    graphs, launches_graphs = {}, []
    rt15 = None  # the terrain's Renderer, built for the last two, which share it
    for label, scene, mode, res, n, kw in (
            ("LTC_BASELINE Cornell (config 1)", cornell, RendererType.LTC_BASELINE, MAIN_RES, GRAPH_SINGLES, {}),
            ("Cornell PATH", cornell, RendererType.PATH, MAIN_RES, GRAPH_FRAMES, {"path_depth": MAIN_DEPTH}),
            ("RATIO Cornell-3", cornell3, RendererType.RATIO, MAIN_RES, GRAPH_FRAMES, {"ratio_samples": RATIO_SAMPLES}),
            ("config 6", gallery, RendererType.PATH, GALLERY_RES, GRAPH_FRAMES, {"path_depth": MAIN_DEPTH}),
            ("config 5", terrain, RendererType.NORMALS, TERRAIN_RES, GRAPH_SINGLES, None),
            ("config 5b", terrain, RendererType.PATH, TERRAIN_RES, GRAPH_FRAMES_5B, None)):
        if kw is None:
            if rt15 is None:
                rt15 = Renderer(terrain, width=TERRAIN_RES, height=TERRAIN_RES, mode=mode, path_depth=MAIN_DEPTH,
                                device=dev)
            rt15.set_mode(mode)
            rend = rt15
        else:
            rend = Renderer(scene, width=res, height=res, mode=mode, device=dev, **kw)
        graphs[label], got = graph_vs_eager(label, rend, scene.cameras[0], n)
        launches_graphs += got
        del rend
    del rt15
    # interleaving on config 6: render(3), a detached frame on a side stream and its commit, a rebaking
    # set_camera, render(3): each step the same frames, and the same launches, as the eager frames from its
    # state (the reference's launches counted apart), and one capture in all
    ri = Renderer(gallery, width=GALLERY_RES, height=GALLERY_RES, mode=RendererType.PATH, path_depth=MAIN_DEPTH,
                  device=dev)
    warm_up(ri, gallery.cameras[0])
    n_cap, graph = len(captures), ri._frames.slots[0].graph
    launches_interleave = []

    def interleaved(label, n, run):
        reset_counts()
        want, frames = eager_frames(ri, ri.state, n)
        l_eager = launch_counts()
        reset_counts()
        run()
        l_run = launch_counts()
        reset_counts()
        same_frames(f"interleaving {label}", ri.state, ri.gbuffers, ri.aux, want, frames)
        _require(l_run == l_eager and any(l_run.values()),
                 f"interleaving {label}: launches {l_run}, the eager frames' {l_eager}")
        launches_interleave.append(l_run)

    def detached_and_commit():
        frame, syncs_i = detached_on_side_stream(ri)
        _require(not syncs_i, f"interleaving: the detached frame synchronizes with the card at {syncs_i}")
        ri.commit_step(*frame, 0.0)

    interleaved(f"render({INTERLEAVE_FRAMES})", INTERLEAVE_FRAMES, lambda: ri.render(INTERLEAVE_FRAMES))
    interleaved("detached + commit", 1, detached_and_commit)
    origin0 = ri.baked_tab.origin.copy()
    g0 = gallery.cameras[0]
    ri.set_camera(SceneCamera(from_=np.float32(CLI_CAM_FROM), at=g0.at, up=g0.up, cos_fovy=g0.cos_fovy))
    _require(not np.array_equal(ri.baked_tab.origin, origin0), "interleaving: set_camera did not rebake")
    interleaved(f"render({INTERLEAVE_FRAMES}) after the rebake", INTERLEAVE_FRAMES,
                lambda: ri.render(INTERLEAVE_FRAMES))
    _require(len(captures) == n_cap and ri._frames.slots[0].graph is graph,
             f"interleaving: captured again ({captures[n_cap:]})")
    del ri, graph
    launches_graphs += launches_interleave
    print(f"  interleaving on config 6: render({INTERLEAVE_FRAMES}), a detached frame on a side stream and its "
          f"commit, a rebaking set_camera, render({INTERLEAVE_FRAMES}): bit-equal to the same frames run eagerly, "
          f"launches {launches_interleave} (each step's equal to its eager frames'), no capture after the first, "
          f"0 implicit syncs in the detached frame", flush=True)
    print(f"  captures (host ms, synchronize to synchronize), every key of the run: "
          + "; ".join(f"{c['frame']} on {c['thread']} {c['ms']:.3f}" for c in captures), flush=True)
    print(f"[15 frame graph] every frame a replay of its key's graph: bit-equal to eager frames in "
          f"{', '.join(graphs)}, detached frames, the interleaving; {len(captures)} captures in the run, "
          f"on {smi}", flush=True)
    phase_done("phase 15")

    launches = {k: sum(c[k] for c in (launches_path, launches_ltc, launches_ratio, launches_c5, launches_c6,
                                      launches_c5b, launches_split, launches_spp, launches_split_t, launches_viewer,
                                      *launches_graphs))
                for k in launches_path}
    _require(launches["cluster_closest_walk"] > 0 and launches["cluster_any_walk"] > 0
             and launches["cluster_closest_walk_baked"] > 0,
             f"the walk of B3 or B4 or the baked walk never ran on a main path: {launches}")
    src = "optix_renderer_tpu_torch/csrc/brute_trace.cu"
    csrc = "optix_renderer_tpu_torch/csrc/cluster_trace.cu"
    pc = "optix_renderer_tpu/accel/pallas_cluster.py"
    record = {"kernels": [
        {"name": "brute_closest", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:88",
         "launches": launches["brute_closest"], "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
         "bound_ms": bound_c[0], "bound_by": bound_c[1], "library_ms": None,
         "resources": brute_res, "live_lane_share_per_launch": live_b1,
         "cap": {"triangles": capb.num_tris, "rows": rows_c,
                 "primary 1024^2": {"ms": cap_c, "plain_ms": cap_plain_c, "bound_ms": cap_bound_c[0],
                                    "bound_by": cap_bound_c[1]},
                 "bounce 1M": {"ms": cap_cb, "plain_ms": cap_plain_cb, "bound_ms": cap_bound_cb[0],
                               "bound_by": cap_bound_cb[1]}},
         "cornell bounce 1M": {"ms": ms_cb, "plain_ms": plain_cb}, "edge_cases": n_edges, "crossover": cross},
        {"name": "brute_any", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:124",
         "launches": launches["brute_any"], "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a[0], "bound_by": bound_a[1], "library_ms": None,
         "resources": brute_res, "live_lane_share_per_launch": live_b2,
         "cap": {"triangles": capb.num_tris, "rows": rows_c,
                 "shadow 1M": {"ms": cap_a, "plain_ms": cap_plain_a, "bound_ms": cap_bound_a[0],
                               "bound_by": cap_bound_a[1]}},
         "edge_cases": n_edges},
        # B3 and B4, the walks: ms, plain_ms and bound_ms on the 1M incoherent rays; `inputs` holds each
        # input's numbers
        {"name": "cluster_closest", "route": "cuda", "source": csrc, "replaces": f"{pc}:848",
         "launches": launches["cluster_closest_walk"], "max_abs_err": max(b3w["max_abs_err"], b3p["max_abs_err"]),
         "ms": b3w["ms"], "plain_ms": b3w["plain_ms"], "plain_tiles": SAMPLE_TILES, "sample_ms": b3w["sample_ms"],
         "bound_ms": b3w["bound_ms"], "bound_by": b3w["bound_by"], "library_ms": None,
         "inputs": {"1M bounce rays": b3w, "1024^2 primaries": b3p}},
        {"name": "cluster_any", "route": "cuda", "source": csrc, "replaces": f"{pc}:1020",
         "launches": launches["cluster_any_walk"], "max_abs_err": b4w["max_abs_err"], "ms": b4w["ms"],
         "plain_ms": b4w["plain_ms"], "plain_tiles": SAMPLE_TILES, "sample_ms": b4w["sample_ms"],
         "bound_ms": b4w["bound_ms"], "bound_by": b4w["bound_by"], "library_ms": None,
         "inputs": {"1M NEE rays": b4w, "tetra3 4M RATIO visibility rays": ratio_vis["b4"]},
         "ratio_visibility_launches": {"frame": ratio_vis["frame_launches"],
                                       "batch": ratio_vis["visibility_launches"]},
         "ratio_visibility_masked": {k: ratio_vis[k] for k in ("lanes", "traced", "b4_work", "masked_vs_unmasked")}},
        # B3-baked: ms, unbaked_walk_ms and bound_ms on the 1024^2 terrain primaries from the Renderer's own
        # table (camera 0); plain_ms on the 64-tile sample; `origins` holds both cameras' numbers
        {"name": "cluster_closest_baked", "route": "cuda", "source": csrc, "replaces": f"{pc}:848 (baked, :984)",
         "launches": launches["cluster_closest_walk_baked"],
         "max_abs_err": max(v["max_abs_err"] for v in b3k.values()), "ms": b3k["camera 0"]["ms"],
         "plain_ms": b3k["camera 0"]["plain_ms"], "plain_tiles": SAMPLE_TILES,
         "sample_ms": b3k["camera 0"]["sample_ms"], "bound_ms": b3k["camera 0"]["bound_ms"],
         "bound_by": b3k["camera 0"]["bound_by"], "library_ms": None,
         "unbaked_walk_ms": b3k["camera 0"]["unbaked_walk_ms"], "bake_ms": bake_ms, "origins": b3k},
        # K4: the cluster tier's winners to the SurfaceInteraction, B5's fetch fused in; ms, plain_ms and bound_ms
        # (each distinct row once) at the tetra's 1M cosine bounce winners; `inputs` holds every batch's
        {"name": "cluster_shade", "route": "cuda", "source": "optix_renderer_tpu_torch/csrc/cluster_shade.cu",
         "replaces": f"{pc}:1657 and optix_renderer_tpu/engine/shade.py:168", "launches": launches["cluster_shade"],
         "max_abs_err": max(v["max_abs_err"] for v in k4.values()), "ms": k4["tetra bounce"]["ms"],
         "plain_ms": k4["tetra bounce"]["plain_ms"], "bound_ms": k4["tetra bounce"]["bound"][0],
         "bound_by": k4["tetra bounce"]["bound"][1], "library_ms": None, "sass_instructions": k4_sass,
         "inputs": k4},
        # B6: ms, plain_ms and bound_ms at the Cornell LTC frame (L = 2); `by_lights` at every input
        {"name": "ltc", "route": "cuda", "source": "optix_renderer_tpu_torch/csrc/ltc.cu",
         "replaces": "optix_renderer_tpu/shading/ltc_pallas.py:154",
         "launches": launches["ltc"], "max_abs_err": err_l, "ms": ltc_times["L=2"][0],
         "plain_ms": ltc_times["L=2"][1], "bound_ms": bound_l[0], "bound_by": bound_l[1], "library_ms": None,
         "by_lights": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": ltc_bounds[k][0],
                           "bound_by": ltc_bounds[k][1], "ops": ltc_ops[k]} for k, v in ltc_times.items()}},
        # K-sweep: the cluster tier's supercluster sweep, a hand kernel with no Pallas counterpart; ms, plain_ms
        # and bound_ms at the terrain's 1M cosine bounce rays (key and t bound); `inputs` holds every batch's
        {"name": "sc_sweep", "route": "cuda", "source": "optix_renderer_tpu_torch/csrc/sc_sweep.cu",
         "replaces": f"{pc}:151", "launches": launches["sc_sweep"], "max_abs_err": 0.0,
         "ms": sweep_k["1M cosine bounce rays"]["ms"], "plain_ms": sweep_k["1M cosine bounce rays"]["plain_ms"],
         "bound_ms": sweep_k["1M cosine bounce rays"]["bound"][0],
         "bound_by": sweep_k["1M cosine bounce rays"]["bound"][1], "library_ms": None,
         "inputs": {**sweep_k, "tetra3 4M RATIO visibility rays": ratio_vis["sweep"]}},
        # K0-K3: hand kernels with no Pallas counterpart (the JAX package leaves this code to XLA's fusions);
        # ms, plain_ms and bound_ms at a 1024^2 Cornell frame's camera head (K0) and at an eager Cornell PATH
        # frame's 1M lanes (K1, K2 its second bounce, K3 its primaries; `bounce 1` K3 at that bounce)
        *({"name": name, "route": "cuda", "source": f"optix_renderer_tpu_torch/csrc/{src_file}", "replaces": rep_at,
           "launches": launches[name], "max_abs_err": bounce_k[name]["max_abs_err"], "ms": bounce_k[name]["ms"],
           "plain_ms": bounce_k[name]["plain_ms"], "bound_ms": bounce_k[name]["bound"][0],
           "bound_by": bounce_k[name]["bound"][1], "library_ms": None,
           **{k: v for k, v in bounce_k[name].items() if k not in ("max_abs_err", "ms", "plain_ms", "bound")}}
          for name, src_file, rep_at in (
              ("camera_rng", "camera_rng.cu", "optix_renderer_tpu/engine/renderer.py:89"),
              ("path_sample", "path_bounce.cu", "optix_renderer_tpu/integrators/path.py:127"),
              ("path_combine", "path_bounce.cu", "optix_renderer_tpu/integrators/path.py:204"),
              ("brute_shade", "brute_shade.cu", "optix_renderer_tpu/engine/shade.py:100"))),
    ]}
    _require(all(k["launches"] > 0 for k in record["kernels"]), f"a kernel never ran on a main path: {launches}")
    _require(all(math.isfinite(k[f]) for k in record["kernels"]
                 for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
             "non-finite number in the kernels record")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
