#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each printing one line or a few (any failure raises and exits
non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the hand-written kernels from ``optix_renderer_tpu_torch/csrc``,
   one nvcc per library, all started together, with ptxas' register and
   spill report;
3. kernels vs plain, at the main paths' shapes, timed with CUDA events in
   turns (plain, kernel, kernel, plain): B1 (closest hit) and B2
   (occlusion) on the Cornell table (1024^2 primary rays, 1M bounce-like
   rays with ~30 % zero t_max); B6 (LTC) on the operands of an LTC frame
   at 1024^2 on Cornell (2 triangle lights) and on the three-light Cornell
   (6), and on 1M seeded random operands with 7 lights, so that every clip
   case occurs (tolerance of tests/unit/test_ltc_pallas.py, and at least
   99.99 % of rays bit-equal);
4. goldens: ``Renderer(device="cuda")`` on the procedural Cornell box at
   64^2 against ``tests/goldens`` (g-buffers and ltc_direct 1e-4, path
   5e-3 relative RMSE), and RATIO at 64^2 over 4 frames against the
   port's own ``device="cpu"`` run of the same frames (ltc 1e-4, the
   stochastic buffers 5e-3);
5. main path PATH: depth 4, ``scenes/cornell/scene.json`` at 1024^2,
   2 warm-up frames (under CUDA sync debugging: no frame may make the
   host wait for the card) then 16 timed frames;
6. main path LTC_BASELINE: Cornell at 1024^2, 1 warm-up frame, then 16
   single frames, each after ``set_camera`` (a deterministic mode renders
   one frame per accumulation);
7. main path RATIO: the three-light Cornell at 1024^2 with 4 shadow
   samples per pixel, 2 warm-up frames under sync debugging, 16 timed
   frames, then denoise x2 and ratio-combine, checked for the invariants
   of tests/integration/test_ratio_render.py.

Each main path runs with every launch count set to 0 just before it and
reads the counts just after; the kernels' ``launches`` are the sums of
those three reads.  The last three lines are the kernels' JSON record, the
nvidia-smi line and ``{"ok": true, "device": {...}}``.
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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
MAIN_RES, MAIN_DEPTH, WARMUP_FRAMES, TIMED_FRAMES = 1024, 4, 2, 16
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


def _check_ltc(torch, lk, ops, label: str) -> float:
    """B6 against its plain version, with the tolerance of
    tests/unit/test_ltc_pallas.py:97-102 (a vertex z within an ulp of the
    horizon may take another clip case); returns the max abs error."""
    out_k = lk.ltc_integrate_cuda(*ops)
    out_p = lk.ltc_integrate_plain(*ops)
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
    print(f"  B6 {label}: {ops[0].shape[0]} rays x {ops[5].shape[0]} lights, bit-equal rays {bit_equal:.7f}, "
          f"values above rel 1e-3 {frac:.3g}, p99 rel {p99:.3g}, max |err| {err:.3g}, "
          f"non-finite {int((~fin_p).sum().item())}, mean {p.mean().item():.5f}", flush=True)
    return err


def _frame_ltc_operands(torch, r, rnglib, primary_rays, trace_closest_si, ltd, ltc):
    """B6's operands in the first LTC frame of renderer ``r`` (the path of
    render_tile: jittered primary rays, B1, shading, ltc_inputs)."""
    n = r.width * r.height
    lin = torch.arange(n, dtype=torch.int64, device=r.device)
    st = rnglib.make_rng(10007, lin)
    st, ju = rnglib.lcg_randomf(st)
    st, jv = rnglib.lcg_randomf(st)
    rays = primary_rays(r.state.camera, r.width, r.height, ju, jv, lin=lin)
    si, _ = trace_closest_si(r.device_scene, r.bvh, rays)
    _, args = ltd.ltc_inputs(r.device_scene, si, *ltd.shading_frame(rays, si))
    return ltc.kernel_operands(*args)


def _random_ltc_operands(torch, cm, ltc, n: int, n_lights: int, device):
    """The seeded random operands of tests/unit/test_ltc_pallas.py:26-50,
    built on the card by the port's own frame functions."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    p = rng.normal(size=(n, 3)) * 2.0
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    diffuse = rng.uniform(0, 1, size=(n, 3))
    alpha = rng.uniform(0.01, 1, size=(n,))
    lv1 = rng.normal(size=(n_lights, 3)) * 3 + np.array([0, 4, 0])
    lv2 = lv1 + rng.normal(size=(n_lights, 3))
    lv3 = lv1 + rng.normal(size=(n_lights, 3))
    lnorm = np.cross(lv2 - lv1, lv3 - lv1)
    lnorm /= np.linalg.norm(lnorm, axis=1, keepdims=True)
    lemit = rng.uniform(0, 5, size=(n_lights, 3))
    to_local, _ = cm.orthonormal_basis(f32(nrm))
    wo_local = cm.normalize(cm.apply_mat(to_local, f32(wo)), eps=1e-30)
    mat, amp = ltc.fetch_ltc_mat(f32(alpha), cm.spherical_theta(wo_local))
    return ltc.kernel_operands(f32(p), f32(diffuse), to_local, ltc.iso_frame_from_wo_local(wo_local),
                               cm.matrix_inverse_3x3(mat), amp, f32(lv1), f32(lv2), f32(lv3), f32(lnorm),
                               f32(lemit))


def _no_implicit_syncs(torch, fn) -> list:
    """Run ``fn`` under CUDA sync debugging; returns where it synchronized."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()  # Renderer.render ends in torch.cuda.synchronize(), which is not flagged
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sorted({f"{w.filename}:{w.lineno}" for w in caught if "synchronizing" in str(w.message)})


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
    from optix_renderer_tpu_torch.core import math as cm
    from optix_renderer_tpu_torch.core import rng as rnglib
    from optix_renderer_tpu_torch.engine import RendererType
    from optix_renderer_tpu_torch.engine.camera import primary_rays
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.engine.shade import trace_closest_si
    from optix_renderer_tpu_torch.integrators import ltc_direct as ltd
    from optix_renderer_tpu_torch.postprocess.denoise import denoise_and_combine
    from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene
    from optix_renderer_tpu_torch.shading import ltc
    from optix_renderer_tpu_torch.shading import ltc_kernel as lk
    from optix_renderer_tpu_torch.utils import cuda_build

    def reset_counts():
        bt.reset_launch_counts()
        lk.reset_launch_counts()

    def counts():
        return {**bt.LAUNCHES, **lk.LAUNCHES}

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---- 2. build: one nvcc per library, all started together --------------
    libs = {"brute_trace": bt.SOURCES, "ltc": lk.SOURCES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(cuda_build.build_library, name, srcs) for name, srcs in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    build_wall = time.perf_counter() - t0
    bt.kernel_library()
    lk.kernel_library()
    print(f"[2 build] {len(libs)} libraries in {build_wall:.2f} s wall", flush=True)
    for name, (lib_path, build_s) in built.items():
        with open(lib_path + ".log") as f:
            usage = [ln.split("info    :")[-1].strip() for ln in f if "Used" in ln or "spill" in ln]
        print(f"  {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s; ptxas: {usage}", flush=True)

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
    frame_ops = lambda rend: _frame_ltc_operands(  # noqa: E731
        torch, rend, rnglib, primary_rays, trace_closest_si, ltd, ltc)
    ops_l2, ops_l6 = frame_ops(rl), frame_ops(rr)
    ops_rand = _random_ltc_operands(torch, cm, ltc, LTC_RANDOM_RAYS, LTC_RANDOM_LIGHTS, dev)
    err_l = max(_check_ltc(torch, lk, ops_l2, "Cornell LTC frame 1024^2"),
                _check_ltc(torch, lk, ops_l6, "Cornell-3 LTC frame 1024^2"),
                _check_ltc(torch, lk, ops_rand, "random 1M"))
    ltc_times = {}
    for label, ops in (("L=2", ops_l2), ("L=6", ops_l6), ("random L=7", ops_rand)):
        ltc_times[label] = _in_turns(torch, lambda: lk.ltc_integrate_plain(*ops),
                                     lambda: lk.ltc_integrate_cuda(*ops), 3, 20)
    del ops_l6, ops_rand
    print(f"  times on {smi} (CUDA events; plain, kernel, kernel, plain): "
          + "; ".join(f"B6 1024^2 {k} {v[0]:.4f} ms vs plain {v[1]:.4f} ms" for k, v in ltc_times.items()),
          flush=True)

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
    print("[4 goldens] relative RMSE vs tests/goldens (tol 1e-4, path 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in rmse.items())
          + f"; RATIO {GOLDEN_RES}^2 x {GOLDEN_RATIO_FRAMES} frames, card vs cpu (tol 1e-4, sto 5e-3): "
          + ", ".join(f"{k} {v:.3g}" for k, v in ratio_rmse.items()), flush=True)

    # ---- 5. main path PATH at full size -------------------------------------
    syncs = _no_implicit_syncs(torch, lambda: r.render(WARMUP_FRAMES))
    _require(not syncs, f"the PATH render loop synchronizes with the card at {syncs}")
    m0 = dict(r.metrics)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    r.render(TIMED_FRAMES)
    launches_path = counts()
    m1 = dict(r.metrics)
    img = r.image()
    _require(img.shape == (MAIN_RES, MAIN_RES, 3), f"image shape {img.shape}")
    _require(bool(np.isfinite(img).all()), "image has non-finite values")
    _require(float(img.mean()) > 0.0, "image is black")
    want = {"brute_closest": TIMED_FRAMES * (1 + MAIN_DEPTH), "brute_any": TIMED_FRAMES * MAIN_DEPTH, "ltc": 0}
    _require(launches_path == want, f"PATH launch counts {launches_path}, expected {want}")
    secs = m1["seconds"] - m0["seconds"]
    rays = m1["rays_traced"] - m0["rays_traced"]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[5 main path] PATH depth {MAIN_DEPTH} Cornell {MAIN_RES}^2, {TIMED_FRAMES} frames after "
          f"{WARMUP_FRAMES} warm-up: {secs / TIMED_FRAMES * 1e3:.3f} ms/frame, "
          f"{rays / secs / 1e6:.3f} Mrays/s honest ({rays} rays), image mean {img.mean():.5f}, "
          f"peak {peak_gib:.3f} GiB, launches {launches_path}, implicit syncs in {WARMUP_FRAMES} warm-up frames: "
          f"{len(syncs)}, on {smi}", flush=True)
    del r

    # ---- 6. main path LTC_BASELINE at full size -----------------------------
    rl.render(1)  # warm-up
    reset_counts()
    secs = 0.0
    for _ in range(TIMED_FRAMES):
        rl.set_camera(cornell.cameras[0])  # a deterministic mode renders one frame per accumulation
        s0 = rl.metrics["seconds"]
        rl.render(1)
        secs += rl.metrics["seconds"] - s0
    launches_ltc = counts()
    want = {"brute_closest": TIMED_FRAMES, "brute_any": 0, "ltc": TIMED_FRAMES}
    _require(launches_ltc == want, f"LTC_BASELINE launch counts {launches_ltc}, expected {want}")
    img = rl.image()
    _require(img.shape == (MAIN_RES, MAIN_RES, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
             f"LTC_BASELINE image: shape {img.shape}, mean {img.mean()}")
    print(f"[6 main path] LTC_BASELINE Cornell {MAIN_RES}^2, {TIMED_FRAMES} single frames after 1 warm-up: "
          f"{secs / TIMED_FRAMES * 1e3:.3f} ms/frame, {TIMED_FRAMES * n_px / secs / 1e6:.3f} Mrays/s "
          f"(primary rays), image mean {img.mean():.5f}, launches {launches_ltc}, on {smi}", flush=True)
    del rl, ops_l2

    # ---- 7. main path RATIO at full size, then denoise and combine ---------
    syncs = _no_implicit_syncs(torch, lambda: rr.render(WARMUP_FRAMES))
    _require(not syncs, f"the RATIO render loop synchronizes with the card at {syncs}")
    m0 = dict(rr.metrics)
    reset_counts()
    rr.render(TIMED_FRAMES)
    launches_ratio = counts()
    m1 = dict(rr.metrics)
    want = {"brute_closest": TIMED_FRAMES, "brute_any": TIMED_FRAMES, "ltc": TIMED_FRAMES}
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

    launches = {k: launches_path[k] + launches_ltc[k] + launches_ratio[k] for k in launches_path}
    src = "optix_renderer_tpu_torch/csrc/brute_trace.cu"
    record = {"kernels": [
        {"name": "brute_closest", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:88",
         "launches": launches["brute_closest"], "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c},
        {"name": "brute_any", "route": "cuda", "source": src,
         "replaces": "optix_renderer_tpu/accel/pallas_trace.py:124",
         "launches": launches["brute_any"], "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a},
        {"name": "ltc", "route": "cuda", "source": "optix_renderer_tpu_torch/csrc/ltc.cu",
         "replaces": "optix_renderer_tpu/shading/ltc_pallas.py:154",
         "launches": launches["ltc"], "max_abs_err": err_l, "ms": ltc_times["L=2"][0],
         "plain_ms": ltc_times["L=2"][1]},
    ]}
    _require(all(k["launches"] > 0 for k in record["kernels"]), f"a kernel never ran on a main path: {launches}")
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
