"""The cluster-tier slice as a whole: the port's ``Renderer(device="cpu")``
on scenes above 4096 triangles, which traces through the plain walk,
against the JAX ``Renderer`` on the CPU (also with its cull forced to cut
lists, so that its checked fallback runs) and against the committed
gallery goldens.

Tolerances (relative RMSE, as tests/goldens/test_goldens.py::_check): 1e-4
for g-buffers, LTC and RATIO's LTC buffer; 5e-3 for PATH and RATIO's
stochastic buffers (Monte Carlo estimates through different floating-point
orders; the port's PATH tolerance since its first slice).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from optix_renderer_tpu.accel import pallas_cluster as pc
from optix_renderer_tpu.accel import traverse as jtraverse
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
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


@pytest.mark.parametrize("mode", [RendererType.PATH, RendererType.RATIO], ids=["path", "ratio"])
def test_renderer_matches_jax_with_its_fallback_forced(terrain_path, monkeypatch, mode):
    """The JAX renderer on its card path (the Pallas cluster tier, here in
    interpret mode) with its culls forced to cut lists: two levels,
    superclusters of 16 clusters, at most 2 kept a tile.  Its checked
    fallback runs in the frame's traces, and the port, which walks and
    lists nothing, renders its image.  JAX's compilation caches are
    cleared around the JAX frame: its jitted frame reads the patches only
    when traced afresh, and no trace made with them outlives the test."""
    real_pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        return real_pallas_call(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jtraverse, "_on_cpu", lambda: False)
    for name, value in (("_TWO_LEVEL_MIN_C", 1), ("_SC_GROUP", 16), ("_SC_CAND", 2), ("_SC_CAND_LANE", 2)):
        monkeypatch.setattr(pc, name, value)
    jax.clear_caches()
    try:
        j = JRenderer(jparse_scene(terrain_path), width=32, height=32, mode=mode, path_depth=GOLDEN_DEPTH)
        j.render(1)
        want, jm = j.image(), j.metrics
        want_aux = {k: np.asarray(v) for k, v in j.aux.items()}
    finally:
        jax.clear_caches()
    # the JAX renderer's own statistics: its lists were cut and its fallback ran
    assert all(jm[f"cull_{k}"] > 0 for k in ("overflow", "unresolved_tiles", "retraces")), jm
    r = Renderer(parse_scene(terrain_path), width=32, height=32, mode=mode, path_depth=GOLDEN_DEPTH, device="cpu")
    r.render(1)
    got = r.image()
    assert got.shape == want.shape == (32, 32, 3) and np.isfinite(got).all()
    if mode == RendererType.PATH:
        assert _rel_rmse(got, want) < 5e-3
        assert r.metrics["alive_per_bounce"] == jm["alive_per_bounce"]
    else:
        assert _rel_rmse(got, want) < 1e-4
        for k, tol in (("ltc", 1e-4), ("sto_direct", 5e-3), ("sto_no_vis", 5e-3)):
            assert _rel_rmse(r.aux[k].numpy(), want_aux[k]) < tol, k


def test_cli_renders_a_big_scene_on_cpu(terrain_path, tmp_path):
    out_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", terrain_path, "--renderer",
           "mask", "--res", "16", "--out", str(out_dir), "--cpu"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    manifest = json.loads((out_dir / "render.json").read_text())
    assert set(manifest["metrics"]) == {"frames", "rays_traced", "mrays_per_sec", "alive_per_bounce"}
    assert (out_dir / "mask.png").exists()
