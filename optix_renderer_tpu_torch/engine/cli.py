"""Command-line renderer (counterpart of ``optix_renderer_tpu/engine/cli.py``).

The subset of the JAX CLI that the port's modes support: scene, renderer
mode, samples, resolution, path depth, output directory, checkpoints, the
RATIO denoise-and-combine stage and the device.  ``--device`` defaults to
``cuda`` and fails when no CUDA device is present; ``--cpu`` is
``--device cpu``.  Outputs are the JAX CLI's files, written through
``postprocess.io``.

Examples:
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell/scene.json \\
      --renderer path --spp 16 --res 1024 --depth 4 --out out/
  python -m optix_renderer_tpu_torch.engine.cli --scene scenes/cornell3/scene.json \\
      --renderer ratio --spp 16 --res 1024 --denoise-ratio --out out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..postprocess.io import save_npy, save_png
from ..scene.config import parse_scene
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
    p.add_argument("--depth", type=int, default=10, help="max path depth (PATH mode)")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--save-npy", action="store_true", help="also dump lossless .npy")
    p.add_argument("--checkpoint", default=None, help="resume accumulation from this .npz")
    p.add_argument("--save-checkpoint", default=None, help="write accumulation state here")
    p.add_argument("--denoise-ratio", action="store_true",
                   help="RATIO mode: denoise the stochastic buffers and combine them with the LTC "
                        "buffer on the device; writes ratio_final.png and ratio_final.npy")
    p.add_argument("--device", default="cuda", help="torch device to render on (default: cuda)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    return p


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


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

    r = Renderer(scene, width=width, height=height, mode=mode, path_depth=args.depth, device=device)
    if args.checkpoint:
        r.load_checkpoint(args.checkpoint)
        log.info("resumed at accum_id=%d", r.state.accum_id)
    os.makedirs(args.out, exist_ok=True)
    name = mode.name.lower()

    t0 = time.perf_counter()
    r.render(spp)
    img = r.image()
    dt = time.perf_counter() - t0
    m = r.metrics
    log_ok(log, "rendered %d frame(s) in %.2fs (%.1f Mrays/s honest, %.2f spp/s)"
           % (m["frames"], dt, m["mrays_per_sec"], m["frames"] / max(dt, 1e-9)))
    if r.bvh.clustered:
        log.info("cluster tier: cull overflow %d, retraced traces %d, unresolved tiles %d",
                 m["cull_overflow"], m["cull_retraces"], m["cull_unresolved_tiles"])

    save_png(os.path.join(args.out, f"{name}.png"), img)
    if args.save_npy:
        save_npy(os.path.join(args.out, f"{name}.npy"), img)
    if mode == RendererType.RATIO and r.aux:
        for k in ("ltc", "sto_direct", "sto_no_vis"):
            save_png(os.path.join(args.out, f"{k}.png"), r.aux[k].cpu().numpy())
        if args.denoise_ratio:
            from ..postprocess.denoise import denoise_and_combine

            final = denoise_and_combine(r.aux, r.gbuffers).cpu().numpy()
            save_png(os.path.join(args.out, "ratio_final.png"), final)
            save_npy(os.path.join(args.out, "ratio_final.npy"), final)
    if args.save_checkpoint:
        r.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint -> %s", args.save_checkpoint)

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
            "cull_overflow": m["cull_overflow"],
            "cull_retraces": m["cull_retraces"],
            "cull_unresolved_tiles": m["cull_unresolved_tiles"],
        },
    }
    with open(os.path.join(args.out, "render.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    log.info("outputs -> %s/", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
