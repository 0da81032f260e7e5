"""The plain reference: independent of the renderer, in agreement with the
renderer's CPU path on tiny frames, and failed by its control."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.control import control
from portbench.harness import check, traffic
from portbench.harness.manifest import ROOT, load_manifest
from portbench.reference import render as ref
from portbench.reference.scene import load_scene

from .helpers import TINY

CORNELL = os.path.join(ROOT, "portbench", "scenes", "cornell", "scene.json")


def _port_image(path, res, frames, yaw):
    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene.config import SceneCamera, parse_scene

    r = Renderer(parse_scene(path), width=res, height=res, mode=RendererType.PATH, path_depth=4, device="cpu")
    cam = traffic.orbit_camera(load_scene(path)["cameras"][0], yaw)
    r.set_camera(SceneCamera(from_=cam[0], at=cam[1], up=cam[2], cos_fovy=cam[3]))
    r.render(frames)
    return r.image().reshape(-1, 3), cam


@pytest.mark.parametrize("frames,yaw", [(1, -3.0), (3, 7.5)])
def test_reference_agrees_with_the_renderer_on_a_tiny_cornell_frame(frames, yaw):
    img, cam = _port_image(CORNELL, 16, frames, yaw)
    px = np.arange(16 * 16)
    want = ref.render_pixels(ref.RefScene(load_scene(CORNELL), "cpu"), cam, 16, 16, px, frames)
    assert check.off_share(img.astype(np.float64), want, 1e-3) == 0.0
    assert np.abs(img - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-6)


def test_block_culling_changes_no_answer(monkeypatch):
    tables = load_scene(CORNELL)
    cam = traffic.orbit_camera(tables["cameras"][0], 3.0)
    px = np.arange(0, 256, 3)
    whole = ref.render_pixels(ref.RefScene(tables, "cpu"), cam, 16, 16, px, 2)
    monkeypatch.setattr(ref, "BLOCK", 5)
    blocks = ref.render_pixels(ref.RefScene(tables, "cpu"), cam, 16, 16, px, 2)
    assert np.array_equal(whole, blocks)


def test_reference_loads_nothing_of_the_renderer_or_jax():
    code = ("import sys, numpy as np; sys.path.insert(0, %r)\n"
            "from portbench.reference import render, scene\n"
            "t = scene.load_scene(%r); s = render.RefScene(t, 'cpu')\n"
            "render.render_pixels(s, t['cameras'][0], 8, 8, np.arange(64), 1)\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'optix_renderer_tpu', 'optix_renderer_tpu_torch'}))"
            % (ROOT, CORNELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_bfloat16_control_fails_the_check(cell):
    res = control(cell, 2 ** 31 + 21, "cpu", requests=4, overrides=TINY[cell])
    assert res["off_pixels_pct"] > res["limit"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in load_manifest()["workloads"]])
def test_the_control_fails_at_the_cells_size(cuda, workload):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        res = control(workload, seed, "cuda")
        assert res["off_pixels_pct"] > res["limit"], res


def test_float32_reference_sums_frames_in_order():
    tables = load_scene(CORNELL)
    s = ref.RefScene(tables, "cpu", torch.float32)
    cam = tables["cameras"][0]
    one = [ref.render_pixels(s, cam, 8, 8, np.arange(64), 1, lanes=64)]
    assert one[0].shape == (64, 3) and np.isfinite(one[0]).all()
    a = ref.render_pixels(s, cam, 8, 8, np.arange(64), 4, lanes=64)
    b = ref.render_pixels(s, cam, 8, 8, np.arange(64), 4, lanes=4096)
    assert np.array_equal(a, b)
