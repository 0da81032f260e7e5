#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels from ``optix_renderer_tpu_torch/csrc``;
3. kernels vs plain: B1 (closest hit) and B2 (occlusion) against their
   plain PyTorch versions on the Cornell table, at the main path's shapes
   (1024^2 primary rays, 1M bounce-like rays with ~30 % zero t_max),
   timed with CUDA events;
4. goldens: ``Renderer(device="cuda")`` on the procedural Cornell box at
   64^2 against ``tests/goldens`` (g-buffers 1e-4, path 5e-3 relative RMSE);
5. main path: PATH, depth 4, ``scenes/cornell/scene.json`` at 1024^2,
   2 warm-up frames (under CUDA sync debugging: no frame may make the
   host wait for the card) then 16 timed frames, with the kernels' launch
   counts read around the timed frames.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
MAIN_RES, MAIN_DEPTH, WARMUP_FRAMES, TIMED_FRAMES = 1024, 4, 2, 16
BOUNCE_RAYS = 1 << 20
GOLDEN_RES, GOLDEN_PATH_SPP, GOLDEN_DEPTH = 64, 4, 4
# kernel vs plain: the same f32 operations (the kernels build with
# --fmad=false), so any difference is a fault, up to the rare tie on a
# shared edge where both versions find the same t on two triangles
ID_AGREE_MIN = 0.99999
RTOL, ATOL = 1e-5, 1e-6


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


def _check_closest(torch, bt, tab, o, d, tm, label: str) -> float:
    """B1 against its plain version; returns the max abs error of t, u, v."""
    t_k, id_k, u_k, v_k = bt.trace_closest_cuda(tab, o, d, tm)
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


def _bounce_like_rays(torch, bvh, n: int, device):
    """Rays leaving random points of the scene's triangles into the normal's
    hemisphere, offset like the path tracer's (1e-3 along the normal)."""
    g = torch.Generator(device=device).manual_seed(SEED)
    tri = torch.randint(0, bvh.num_tris, (n,), generator=g, device=device)
    su = torch.sqrt(torch.rand(n, generator=g, device=device))[:, None]
    b = torch.rand(n, generator=g, device=device)[:, None]
    p = bvh.tri_v0[tri] + su * (1.0 - b) * bvh.tri_e1[tri] + su * b * bvh.tri_e2[tri]
    nrm = bvh.tri_tab[tri, 10:13]  # the table's unit normal (sorted row = sorted triangle)
    d = torch.randn((n, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where(((d * nrm).sum(-1) < 0)[:, None], -d, d)
    o = (p + nrm * 1e-3).contiguous()
    zero = torch.rand(n, generator=g, device=device) < 0.3
    tm_closest = torch.where(zero, 0.0, 3.0e38)
    tm_any = torch.where(zero, 0.0, torch.rand(n, generator=g, device=device) * 1200.0)
    return o, d.contiguous(), tm_closest, tm_any


def _golden_rmse(got, want) -> float:
    """Relative RMSE, as tests/goldens/test_goldens.py::_check."""
    import numpy as np

    scale = max(float(np.abs(want).mean()), 1e-6)
    return float(np.sqrt(((got - want) ** 2).mean())) / scale


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
    from optix_renderer_tpu_torch.core import rng as rnglib
    from optix_renderer_tpu_torch.engine import RendererType
    from optix_renderer_tpu_torch.engine.camera import primary_rays
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene
    from optix_renderer_tpu_torch.utils import cuda_build

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---- 2. build --------------------------------------------------------
    lib_path, build_s = cuda_build.build_library("brute_trace", bt.SOURCES)
    bt.kernel_library()
    with open(lib_path + ".log") as f:
        usage = [ln.split("info    :")[-1].strip() for ln in f if "Used" in ln]
    print(f"[2 build] {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s; ptxas: {usage}", flush=True)

    # ---- 3. kernels vs plain at the main path's shapes --------------------
    scene = parse_scene(os.path.join(ROOT, "scenes", "cornell", "scene.json"))
    r = Renderer(scene, width=MAIN_RES, height=MAIN_RES, mode=RendererType.PATH,
                 path_depth=MAIN_DEPTH, device=dev)
    tab = r.bvh.tri_tab
    n_px = MAIN_RES * MAIN_RES
    lin = torch.arange(n_px, dtype=torch.int64, device=dev)
    st = rnglib.make_rng(10007, lin)
    st, ju = rnglib.lcg_randomf(st)
    st, jv = rnglib.lcg_randomf(st)
    prim = primary_rays(r.state.camera, MAIN_RES, MAIN_RES, ju, jv, lin=lin)
    prim_tm = torch.full((n_px,), 3.0e38, device=dev)
    bo, bd, btm_c, btm_a = _bounce_like_rays(torch, r.bvh, BOUNCE_RAYS, dev)
    print(f"[3 kernels] Cornell table {tuple(tab.shape)} ({r.bvh.num_tris} triangles)", flush=True)
    err_c = max(_check_closest(torch, bt, tab, prim.origin, prim.direction, prim_tm, "primary 1024^2"),
                _check_closest(torch, bt, tab, bo, bd, btm_c, "bounce 1M"))
    err_a = _check_any(torch, bt, tab, bo, bd, btm_a, "shadow 1M")
    ms_c, plain_c = _in_turns(
        torch, lambda: bt.trace_closest_plain(tab, prim.origin, prim.direction, prim_tm),
        lambda: bt.trace_closest_cuda(tab, prim.origin, prim.direction, prim_tm), 5, 50)
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

    # ---- 4. the slice against the committed goldens ------------------------
    goldens = {"mask": RendererType.MASK, "normal": RendererType.NORMALS,
               "position": RendererType.POSITION, "diffuse": RendererType.DIFFUSE,
               "alpha": RendererType.ALPHA, "path": RendererType.PATH}
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
    print("[4 goldens] relative RMSE vs tests/goldens (tol 1e-4, path 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in rmse.items()), flush=True)

    # ---- 5. the main path at full size ------------------------------------
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r.render(WARMUP_FRAMES)  # ends in torch.cuda.synchronize(), which is not flagged
    torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchronizing" in str(w.message)]
    _require(not syncs, f"the render loop synchronizes with the card at {sorted(set(syncs))}")
    m0 = dict(r.metrics)
    torch.cuda.reset_peak_memory_stats(dev)
    bt.reset_launch_counts()
    r.render(TIMED_FRAMES)
    launches = dict(bt.LAUNCHES)
    m1 = dict(r.metrics)
    img = r.image()
    _require(img.shape == (MAIN_RES, MAIN_RES, 3), f"image shape {img.shape}")
    _require(bool(np.isfinite(img).all()), "image has non-finite values")
    _require(float(img.mean()) > 0.0, "image is black")
    want = {"brute_closest": TIMED_FRAMES * (1 + MAIN_DEPTH), "brute_any": TIMED_FRAMES * MAIN_DEPTH}
    _require(launches == want, f"launch counts {launches}, expected {want}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[5 main path] PATH depth {MAIN_DEPTH} Cornell {MAIN_RES}^2, {TIMED_FRAMES} frames after "
          f"{WARMUP_FRAMES} warm-up: {secs / TIMED_FRAMES * 1e3:.3f} ms/frame, "
          f"{rays / secs / 1e6:.3f} Mrays/s honest ({rays} rays), image mean {img.mean():.5f}, "
          f"peak {peak_gib:.3f} GiB, launches {launches}, implicit syncs in {WARMUP_FRAMES} warm-up frames: "
          f"{len(syncs)}, on {smi}", flush=True)

    src = "optix_renderer_tpu_torch/csrc/brute_trace.cu"
    record = {"kernels": [
        {"name": "brute_closest", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:88",
         "launches": launches["brute_closest"], "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c},
        {"name": "brute_any", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:124",
         "launches": launches["brute_any"], "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a},
    ]}
    _require(all(math.isfinite(k[f]) for k in record["kernels"] for f in ("max_abs_err", "ms", "plain_ms")),
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
