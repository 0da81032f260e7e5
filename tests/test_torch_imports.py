"""The port imports no JAX, and its CUDA entry points never fall back.

A fresh interpreter imports every module of ``optix_renderer_tpu_torch``,
renders one 16^2 PATH frame and one 16^2 RATIO frame on the CPU, and one
MASK frame of a grid-60 terrain (above 4096 triangles: the cluster tier),
traces 64 incoherent rays per lane there (on CPU tensors that is the list
path with the plain kernels: no kernel is launched), traces the frame's
primaries through the plain baked walk with the shared-origin table of the
camera, runs the CLI with the camera and output flags, renders a frame
through the row split (``parallel.sharding``) and serves frames from the
live viewer (``engine.serve``), and must have loaded neither ``jax`` nor
any module of the JAX package ``optix_renderer_tpu``.
Without a CUDA device, ``Renderer(device="cuda")`` and the CLI's default
``--device cuda`` must fail with a clear message rather than render on
the CPU.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, pkgutil, sys, tempfile
import numpy as np
import optix_renderer_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
assert {"optix_renderer_tpu_torch.parallel.sharding", "optix_renderer_tpu_torch.engine.serve"} <= set(mods), mods
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene, write_terrain_scene
scene = parse_scene(write_cornell_scene(tempfile.mkdtemp(), width=16, height=16))
r = Renderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=4, device="cpu")
r.render(1)
img = r.image()
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0, img.mean()
from optix_renderer_tpu_torch.parallel import sharding
from optix_renderer_tpu_torch.engine.serve import ViewerServer
sharding.render_rows(r, ["cpu"] * 4, 1)
assert r.state.accum_id == 2 and np.isfinite(r.image()).all()
import time
server = ViewerServer(r, port=0, out_dir=tempfile.mkdtemp(), max_spp=3)
server.start()
t0 = time.monotonic()
while server.status()["accum_id"] < 3 and time.monotonic() - t0 < 60:
    time.sleep(0.02)
server.shutdown()
assert server.error is None and server.status()["accum_id"] == 3, server.status()
r = Renderer(scene, width=16, height=16, mode=RendererType.RATIO, device="cpu")
r.render(1)
assert np.isfinite(r.image()).all() and float(r.aux["sto_no_vis"].max()) > 0
TERRAIN = write_terrain_scene(tempfile.mkdtemp(), grid=60, width=16, height=16)
terrain = parse_scene(TERRAIN)
r = Renderer(terrain, width=16, height=16, mode=RendererType.MASK, device="cpu")
assert r.bvh.num_tris > 4096
r.render(1)
assert 0 < r.image().mean() <= 1
import torch
from optix_renderer_tpu_torch.accel import cluster_trace, traverse
from optix_renderer_tpu_torch.core.types import Ray
g = torch.Generator().manual_seed(1)
top = r.bvh.cluster_max.amax(dim=0)
o = torch.rand((64, 3), generator=g) * top
o[:, 1] = top[1] * 1.1
d = torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=-1)
key, cid, t_b, _ = traverse.trace_closest_winners(r.bvh, Ray(origin=o, direction=d), coherent=False)
occ = traverse.trace_any(r.bvh, Ray(origin=o, direction=d), t_max=1e4, coherent=False)
assert (occ == (cid >= 0)).all() and 0 < int(occ.sum()) < 64, int(occ.sum())
from optix_renderer_tpu_torch.accel import cluster
from optix_renderer_tpu_torch.engine import cli
from optix_renderer_tpu_torch.engine.camera_kernel import pixel_order
from optix_renderer_tpu_torch.utils.bench_rays import first_frame_primaries
prim = first_frame_primaries(r, pixel_order(16, 16, "cpu"))
baked = cluster.bake_shared_origin_tab(r.bvh.tri_tab, terrain.cameras[0].from_)
key_b, cid_b, _t, _s = traverse.trace_closest_winners(r.bvh, prim, baked_tab=baked)
key_u, cid_u, _t, _s = traverse.trace_closest_winners(r.bvh, prim)
assert (cid_b >= 0).any() and ((cid_b == cid_u).float().mean() >= 0.99), (cid_b == cid_u).float().mean()
out = tempfile.mkdtemp()
assert cli.main(["--scene", TERRAIN, "--renderer", "normals",
                 "--res", "8", "--cam-from", "1", "2", "3", "--save-gbuffers", "--save-exr", "--profile", out + "/p",
                 "--out", out, "--cpu"]) == 0
assert not any(cluster_trace.LAUNCHES.values()), cluster_trace.LAUNCHES
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
ref = sorted(m for m in sys.modules if m == "optix_renderer_tpu" or m.startswith("optix_renderer_tpu."))
print("MODULES", len(mods))
print("JAX", loaded)
print("REF", ref)
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"  # like the test modules' torch.set_num_threads(2): no oversubscription
    return env


def test_port_imports_and_renders_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path, env=_child_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines() if ln.startswith(("MODULES", "JAX", "REF")))
    assert int(lines["MODULES"]) >= 15, out.stdout
    assert lines["JAX"] == "[]", f"the port loaded JAX: {lines['JAX']}"
    assert lines["REF"] == "[]", f"the port loaded modules of the JAX package: {lines['REF']}"


def test_cuda_renderer_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path cannot be exercised")
    from optix_renderer_tpu.scene import procedural
    from optix_renderer_tpu.scene.config import parse_scene
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    scene = parse_scene(procedural.write_cornell_scene(str(tmp_path), width=8, height=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene, width=8, height=8, device="cuda")


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path cannot be exercised")
    scene = os.path.join(REPO, "scenes", "cornell", "scene.json")
    out_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", scene,
           "--res", "8", "--spp", "1", "--out", str(out_dir)]
    out = subprocess.run(cmd, cwd=tmp_path, env=_child_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr
    assert not out_dir.exists(), "nothing may be rendered without the requested device"


def test_cli_renders_on_cpu(tmp_path):
    scene = os.path.join(REPO, "scenes", "cornell", "scene.json")
    out_dir = tmp_path / "out"
    ckpt = tmp_path / "ck.npz"
    cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--scene", scene, "--renderer", "path",
           "--res", "16", "--spp", "2", "--depth", "2", "--out", str(out_dir), "--cpu", "--save-npy",
           "--save-checkpoint", str(ckpt)]
    out = subprocess.run(cmd, cwd=tmp_path, env=_child_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert (out_dir / "path.png").exists() and (out_dir / "render.json").exists() and ckpt.exists()
    import numpy as np

    img = np.load(out_dir / "path.npy")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
