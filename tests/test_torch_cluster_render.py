"""The cluster-tier slice as a whole: the port's ``Renderer(device="cpu")``
on scenes above 4096 triangles against the JAX ``Renderer`` on the CPU and
against the committed gallery goldens.

Tolerances (relative RMSE, as tests/goldens/test_goldens.py::_check): 1e-4
for g-buffers, LTC and RATIO's LTC buffer; 5e-3 for PATH and RATIO's
stochastic buffers (Monte Carlo estimates through different floating-point
orders; the port's PATH tolerance since its first slice).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.accel import cluster
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene.config import parse_scene
from tests.goldens.generate import GALLERY_MODES, SIZE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DEPTH = 4  # tests/goldens/generate.py renders every mode at path_depth=4
# 64 x 48: pixel blocks of 32 x 16, so the block order is not square
W, H = 64, 48


def _rel_rmse(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


@pytest.fixture(scope="module")
def terrain_path(tmp_path_factory):
    return procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain60_render")), grid=60, width=W,
                                          height=H)


@pytest.mark.parametrize("mode,spp,tol", [(RendererType.MASK, 1, 1e-4), (RendererType.NORMALS, 1, 1e-4),
                                          (RendererType.PATH, 1, 5e-3)])
def test_terrain_matches_jax_renderer(terrain_path, mode, spp, tol):
    j = JRenderer(jparse_scene(terrain_path), width=W, height=H, mode=mode, path_depth=GOLDEN_DEPTH)
    j.render(spp)
    r = Renderer(parse_scene(terrain_path), width=W, height=H, mode=mode, path_depth=GOLDEN_DEPTH, device="cpu")
    assert r.bvh.clustered and r.bvh.num_tris > 4096
    r.render(spp)
    want, got = j.image(), r.image()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < tol
    m = r.metrics
    assert m["cull_overflow"] == m["cull_retraces"] == m["cull_unresolved_tiles"] == 0
    if mode == RendererType.PATH:
        assert m["alive_per_bounce"] == j.metrics["alive_per_bounce"]
        assert m["rays_traced"] == j.metrics["rays_traced"]


def test_terrain_ratio_matches_jax_renderer(terrain_path):
    """RATIO's aux buffers come back in pixel order from the block order."""
    j = JRenderer(jparse_scene(terrain_path), width=32, height=32, mode=RendererType.RATIO)
    j.render(1)
    r = Renderer(parse_scene(terrain_path), width=32, height=32, mode=RendererType.RATIO, device="cpu")
    r.render(1)
    assert _rel_rmse(r.image(), j.image()) < 1e-4
    for k, tol in (("ltc", 1e-4), ("sto_direct", 5e-3), ("sto_no_vis", 5e-3)):
        got, want = r.aux[k].numpy(), np.asarray(j.aux[k])
        assert got.shape == want.shape and _rel_rmse(got, want) < tol, k


@pytest.mark.parametrize("name", sorted(GALLERY_MODES))
def test_gallery_golden(name):
    """The committed gallery (5670 triangles, 4 textures) reproduces the
    JAX package's goldens."""
    mode, spp = GALLERY_MODES[name]
    r = Renderer(parse_scene(os.path.join(REPO, "scenes", "gallery", "scene.json")), width=SIZE, height=SIZE,
                 mode=mode, path_depth=GOLDEN_DEPTH, device="cpu")
    assert r.bvh.clustered
    r.render(spp)
    want = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npy"))
    assert _rel_rmse(r.image(), want) < (5e-3 if mode == RendererType.PATH else 1e-4)


def test_forced_fallback_leaves_the_image_unchanged(terrain_path, monkeypatch):
    """Superclusters of 16 clusters, capped at 2 a tile, with the two-level
    culls forced: the checked fallback runs in every trace that overflows,
    the renderer counts it, and the image is the one without caps."""
    want = Renderer(parse_scene(terrain_path), width=32, height=32, mode=RendererType.PATH, path_depth=2,
                    device="cpu")
    want.render(1)
    monkeypatch.setattr(cluster, "_TWO_LEVEL_MIN_C", 1)
    monkeypatch.setattr(cluster, "_SC_GROUP", 16)
    monkeypatch.setattr(cluster, "_SC_CAND", 2)
    monkeypatch.setattr(cluster, "_SC_CAND_LANE", 2)
    got = Renderer(parse_scene(terrain_path), width=32, height=32, mode=RendererType.PATH, path_depth=2,
                   device="cpu")
    got.render(1)
    m = got.metrics
    assert m["cull_overflow"] > 0 and m["cull_unresolved_tiles"] > 0 and m["cull_retraces"] > 0
    assert _rel_rmse(got.image(), want.image()) < 1e-6
    assert m["alive_per_bounce"] == want.metrics["alive_per_bounce"]


def test_cli_renders_a_big_scene_on_cpu(terrain_path, tmp_path):
    out_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", terrain_path, "--renderer",
           "mask", "--res", "16", "--out", str(out_dir), "--cpu"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "cluster tier: cull overflow 0" in out.stderr
    manifest = json.loads((out_dir / "render.json").read_text())
    assert {"cull_overflow", "cull_retraces", "cull_unresolved_tiles"} <= set(manifest["metrics"])
    assert (out_dir / "mask.png").exists()
