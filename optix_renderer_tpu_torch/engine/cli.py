"""Command-line renderer (counterpart of ``optix_renderer_tpu/engine/cli.py``).

The JAX CLI's flags: scene, renderer mode, samples, resolution, path
depth, camera (``--camera``, ``--cam-from/--cam-to/--cam-up/--cam-fovy``,
``--record-camera``), output directory and files (``--save-npy``,
``--save-exr``, ``--save-gbuffers``), checkpoints (a resumed camera wins
over the flags), the RATIO denoise-and-combine stage, ``--preview N``,
``--profile DIR`` (a ``torch.profiler`` trace of the render loop,
``render_loop.pt.trace.json``, holding the port's own spans, and beside it
``render_loop.stages.json``: ``Renderer.frame_stages()``, the stage map of
the frame graph, whose ``stages`` name the ``frame.*`` span that made each
operation of a replay by its position in the replay, and whose
``kernels`` give the hand kernels' positions; null off the card, where
frames are not replays),
``--devices N`` (the frames split by image rows over ``cuda:0`` ..
``cuda:N-1``, or over N CPU tiles with ``--cpu``: the same image, bit for
bit; refused when fewer cards exist), ``--bvh-cache DIR`` (the trace
tables through a content-addressed cache), ``--serve [PORT]`` (the live
viewer instead of a batch render, ``max_spp`` = ``--spp`` or 0) and the
device.  ``--device`` defaults to ``cuda`` and fails, whatever the other
flags, when no CUDA device is present; ``--cpu`` is ``--device cpu``.
Outputs are the JAX CLI's files for the same flags, written through
``postprocess.io``.

Examples:
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell/scene.json \\
      --renderer path --spp 16 --res 1024 --depth 4 --out out/
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell3/scene.json \\
      --renderer ratio --spp 16 --res 1024 --denoise-ratio --out out/
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/gallery/scene.json \\
      --renderer path --spp 16 --res 512 --depth 4 --cam-from 200 320 -400 --save-gbuffers --out out/
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell/scene.json \\
      --renderer path --spp 16 --res 1024 --depth 4 --devices 4 --bvh-cache bvh/ --out out/
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell/scene.json --serve 8000
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ..postprocess.io import save_exr, save_npy, save_png
from ..scene.config import SceneCamera, parse_scene
from ..utils.log import get_logger, log_ok
from .modes import DETERMINISTIC_MODES, RENDERER_NAMES, RendererType

log = get_logger()

_MODE_BY_NAME = {n.lower().replace(" ", "_"): RendererType(i) for i, n in enumerate(RENDERER_NAMES)}
_MODE_BY_NAME.update({m.name.lower(): m for m in RendererType})


def resolve_mode(arg: str | None, scene) -> RendererType:
    """A mode from its name or int id; default: the scene's first renderer."""
    if arg is None:
        return RendererType(scene.renderers[0]) if scene.renderers else RendererType.PATH
    try:
        return RendererType(int(arg))
    except ValueError:
        key = arg.lower().replace("-", "_")
        if key not in _MODE_BY_NAME:
            raise SystemExit(f"unknown renderer {arg!r}; choose from {sorted(set(_MODE_BY_NAME))}")
        return _MODE_BY_NAME[key]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="optix_renderer_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True, help="scene JSON (reference schema)")
    p.add_argument("--renderer", default=None,
                   help=f"one of {sorted(set(_MODE_BY_NAME))} or an int mode id; "
                        "default: the scene's first renderer")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel (default: scene spp)")
    p.add_argument("--res", type=int, default=None, help="square resolution override")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--camera", type=int, default=0, help="camera index from the scene (past the end: 0)")
    p.add_argument("--cam-from", type=float, nargs=3, default=None, help="camera position override")
    p.add_argument("--cam-to", type=float, nargs=3, default=None, help="camera look-at override")
    p.add_argument("--cam-up", type=float, nargs=3, default=None, help="camera up override")
    p.add_argument("--cam-fovy", type=float, default=None, help="cos_fovy override")
    p.add_argument("--record-camera", action="store_true",
                   help="append the active camera to the scene JSON's cameras (viewer.hpp R/F keys)")
    p.add_argument("--depth", type=int, default=10, help="max path depth (PATH mode)")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--save-gbuffers", action="store_true", help="dump all g-buffers")
    p.add_argument("--save-npy", action="store_true", help="also dump lossless .npy")
    p.add_argument("--save-exr", action="store_true", help="also dump float32 EXR")
    p.add_argument("--checkpoint", default=None, help="resume accumulation (and its camera) from this .npz")
    p.add_argument("--save-checkpoint", default=None, help="write accumulation state here")
    p.add_argument("--denoise-ratio", action="store_true",
                   help="RATIO mode: denoise the stochastic buffers and combine them with the LTC "
                        "buffer on the device; writes ratio_final.png (and ratio_final.npy with --save-npy)")
    p.add_argument("--preview", type=int, default=0, metavar="N",
                   help="write a progressive preview PNG every N frames")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render loop into DIR")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="split the render over N devices by image rows (cuda:0..N-1, or N CPU tiles with "
                        "--cpu; needs height %% N == 0)")
    p.add_argument("--bvh-cache", metavar="DIR", default=None,
                   help="load or store the trace tables in DIR (content-addressed)")
    p.add_argument("--serve", type=int, nargs="?", const=8000, default=None, metavar="PORT",
                   help="start the live HTTP viewer (orbit camera, runtime mode switch; viewer.hpp:659-845) "
                        "instead of a batch render")
    p.add_argument("--device", default="cuda", help="torch device to render on (default: cuda)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    return p


def _split_devices(n: int, device: torch.device) -> list[torch.device]:
    """``--devices N``: cuda:0..N-1 on a CUDA device, else N tiles on ``device``."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _camera(args, scene) -> SceneCamera:
    """The scene's camera ``--camera`` (0 past the end), with the ``--cam-*``
    overrides."""
    cam = scene.cameras[args.camera if args.camera < len(scene.cameras) else 0]
    if all(v is None for v in (args.cam_from, args.cam_to, args.cam_up, args.cam_fovy)):
        return cam
    pick = lambda flag, own: np.asarray(flag if flag is not None else own, np.float32)  # noqa: E731
    return SceneCamera(from_=pick(args.cam_from, cam.from_), at=pick(args.cam_to, cam.at),
                       up=pick(args.cam_up, cam.up),
                       cos_fovy=float(args.cam_fovy if args.cam_fovy is not None else cam.cos_fovy))


def _record_camera(scene_path: str, cam: SceneCamera) -> None:
    """Append the camera to the scene JSON (viewer.hpp:802-845: R records
    into Viewer::cameras, F rewrites the JSON's 'cameras' array)."""
    with open(scene_path) as f:
        cfg = json.load(f)
    cfg.setdefault("cameras", []).append({
        "from": [float(x) for x in cam.from_],
        "to": [float(x) for x in cam.at],
        "up": [float(x) for x in cam.up],
        "cos_fovy": float(cam.cos_fovy),
    })
    with open(scene_path, "w") as f:
        json.dump(cfg, f, indent=2)


def _render_loop(r, spp: int, preview: int, preview_path: str, devices: list | None) -> None:
    """``spp`` frames, split over ``devices`` when given; with ``preview`` <
    spp, in steps of ``preview`` frames, each followed by the image so far at
    ``preview_path``."""
    if devices:
        from ..parallel.sharding import render_rows

        render_rows(r, devices, spp)
        log.info("split by rows over %d devices (%s)", len(devices), ", ".join(map(str, devices)))
        return
    if not (preview and preview < spp):
        r.render(spp)
        return
    done = 0
    while done < spp:
        step = min(preview, spp - done)
        r.render(step)
        done += step
        save_png(preview_path, r.image())
        log.info("preview %d/%d spp", done, spp)


@contextlib.contextmanager
def _profiled(out_dir: str | None, r):
    """A ``torch.profiler`` trace of the block, written into ``out_dir``
    (the card's kernels too on a CUDA device), and the stage map of
    ``r``'s frame graph beside it; nothing without ``out_dir``."""
    if not out_dir:
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if r.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    trace = os.path.join(out_dir, "render_loop.pt.trace.json")
    prof.export_chrome_trace(trace)
    stages = os.path.join(out_dir, "render_loop.stages.json")
    with open(stages, "w") as f:
        json.dump(r.frame_stages(), f)
    log.info("profiler trace -> %s, stage map -> %s", trace, stages)


def _save_gbuffers(out: str, gb, npy: bool, exr: bool) -> None:
    """The five g-buffers as linear PNGs (the normal mapped to n/2 + 1/2),
    and as .npy and .exr when asked."""
    for field, arr in (("position", gb.position), ("normal", gb.normal * 0.5 + 0.5), ("albedo", gb.albedo),
                       ("alpha", gb.alpha), ("material_id", gb.material_id)):
        arr = arr.cpu().numpy()
        save_png(os.path.join(out, f"gbuffer_{field}.png"), arr, apply_gamma=False)
        if npy:
            save_npy(os.path.join(out, f"gbuffer_{field}.npy"), arr)
        if exr:
            save_exr(os.path.join(out, f"gbuffer_{field}.exr"), arr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: torch.cuda.is_available() is false (no CUDA device "
            "or a CPU-only PyTorch); pass --device cpu (or --cpu) to render on the CPU")

    from .renderer import Renderer

    scene = parse_scene(args.scene)
    mode = resolve_mode(args.renderer, scene)
    width = args.width or args.res or scene.img_width
    height = args.height or args.res or scene.img_height
    spp = args.spp if args.spp is not None else scene.spp
    if mode in DETERMINISTIC_MODES:
        spp = 1
    log.info("scene=%s mode=%s %dx%d spp=%d depth=%d device=%s",
             args.scene, mode.name, width, height, spp, args.depth, _device_name(device))

    devices = None
    if args.devices > 1:
        from ..parallel.sharding import check_devices

        try:  # no fewer cards than asked for, and whole row tiles
            devices = check_devices(_split_devices(args.devices, device), height)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--devices {args.devices}: {e}")
    r = Renderer(scene, width=width, height=height, mode=mode, path_depth=args.depth, device=device,
                 bvh_cache_dir=args.bvh_cache)
    cam = _camera(args, scene)
    r.set_camera(cam)
    if args.checkpoint:  # after the flags: a resumed camera wins
        r.load_checkpoint(args.checkpoint)
        log.info("resumed at accum_id=%d", r.state.accum_id)
    os.makedirs(args.out, exist_ok=True)
    name = mode.name.lower()

    if args.serve is not None:
        from .serve import ViewerServer

        server = ViewerServer(r, scene_path=args.scene, port=args.serve, out_dir=args.out, max_spp=args.spp or 0)
        log.info("live viewer: http://127.0.0.1:%d/  (ctrl-C to stop)", server.port)
        server.serve_forever()
        return 0

    t0 = time.perf_counter()
    with _profiled(args.profile, r):
        _render_loop(r, spp, args.preview, os.path.join(args.out, f"{name}_preview.png"), devices)
    img = r.image()
    dt = time.perf_counter() - t0
    m = r.metrics
    log_ok(log, "rendered %d frame(s) in %.2fs (%.1f Mrays/s honest, %.2f spp/s)"
           % (m["frames"], dt, m["mrays_per_sec"], m["frames"] / max(dt, 1e-9)))

    save_png(os.path.join(args.out, f"{name}.png"), img)
    if args.save_npy:
        save_npy(os.path.join(args.out, f"{name}.npy"), img)
    if args.save_exr:
        save_exr(os.path.join(args.out, f"{name}.exr"), img)
    if args.save_gbuffers and r.gbuffers is not None:
        _save_gbuffers(args.out, r.gbuffers, args.save_npy, args.save_exr)
    if mode == RendererType.RATIO and r.aux:
        for k in ("ltc", "sto_direct", "sto_no_vis"):
            save_png(os.path.join(args.out, f"{k}.png"), r.aux[k].cpu().numpy())
        if args.denoise_ratio:
            from ..postprocess.denoise import denoise_and_combine

            final = denoise_and_combine(r.aux, r.gbuffers).cpu().numpy()
            save_png(os.path.join(args.out, "ratio_final.png"), final)
            if args.save_npy:
                save_npy(os.path.join(args.out, "ratio_final.npy"), final)
    if args.save_checkpoint:
        r.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint -> %s", args.save_checkpoint)
    if args.record_camera:
        _record_camera(args.scene, cam)
        log.info("camera recorded into %s", args.scene)

    manifest = {
        "scene": os.path.abspath(args.scene),
        "mode": mode.name,
        "width": width,
        "height": height,
        "spp": r.state.accum_id,
        "seconds": dt,
        "device": _device_name(device),
        "metrics": {
            "frames": m["frames"],
            "rays_traced": m["rays_traced"],
            "mrays_per_sec": round(m["mrays_per_sec"], 2),
            "alive_per_bounce": m["alive_per_bounce"],
        },
    }
    with open(os.path.join(args.out, "render.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    log.info("outputs -> %s/", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
