"""The slice as a whole: the port's ``Renderer(device="cpu")`` against the
committed goldens that the JAX ``Renderer`` generated, and checkpoints
carried between the two renderers.

Tolerance: ``tests/goldens/test_goldens.py::_check`` (relative RMSE 1e-4,
5e-3 for path).
"""

import os

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu_torch.engine.renderer import Renderer
from tests.goldens.generate import MODES, SIZE
from tests.goldens.test_goldens import _check

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DEPTH = 4  # tests/goldens/generate.py renders every mode at path_depth=4
PORTED = ("mask", "normal", "position", "diffuse", "alpha", "ltc_direct", "path")


@pytest.fixture(scope="module")
def golden_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden_scene_torch"))
    return parse_scene(procedural.write_cornell_scene(d, width=SIZE, height=SIZE))


@pytest.mark.parametrize("name", PORTED)
def test_port_reproduces_golden(golden_scene, name):
    mode, spp = MODES[name]
    r = Renderer(golden_scene, width=SIZE, height=SIZE, mode=mode, path_depth=GOLDEN_DEPTH, device="cpu")
    r.render(spp)
    img = r.image()
    assert img.dtype == np.float32
    _check(name, img)
    m = r.metrics
    assert m["frames"] == spp and r.state.accum_id == spp
    if mode == RendererType.PATH:
        # honest count: primaries plus the NEE and bounce rays traced
        assert m["rays_traced"] > spp * SIZE * SIZE and len(m["alive_per_bounce"]) == GOLDEN_DEPTH
    else:
        assert m["rays_traced"] == SIZE * SIZE


def test_gbuffer_mode_renders_one_frame(golden_scene):
    r = Renderer(golden_scene, width=16, height=16, mode=RendererType.MASK, device="cpu")
    r.render(3)  # deterministic modes converge in one frame
    assert r.state.accum_id == 1
    assert r.gbuffers.position.shape == (16, 16, 3) and r.gbuffers.alpha.shape == (16, 16)


def test_set_mode_and_camera_restart_accumulation(golden_scene):
    r = Renderer(golden_scene, width=16, height=16, mode=RendererType.PATH, path_depth=2, device="cpu")
    r.render(2)
    r.set_mode(RendererType.NORMALS)
    assert r.state.accum_id == 0 and float(r.state.accum.abs().sum()) == 0.0
    r.render(1)
    r.set_camera(golden_scene.cameras[0])
    assert r.state.accum_id == 0
    # scenes above the brute tier's 4096 triangles take the cluster tier,
    # whose mode and camera changes restart accumulation the same way
    gallery = parse_scene(os.path.join(REPO, "scenes", "gallery", "scene.json"))
    g = Renderer(gallery, width=8, height=8, mode=RendererType.PATH, path_depth=2, device="cpu")
    assert g.bvh.clustered
    g.render(1)
    g.set_mode(RendererType.MASK)
    assert g.state.accum_id == 0 and float(g.state.accum.abs().sum()) == 0.0


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX renders 2 PATH frames at 16^2 and saves a checkpoint, then 2
    more: the image after 4 frames."""
    d = str(tmp_path_factory.mktemp("ckpt_scene"))
    scene = parse_scene(procedural.write_cornell_scene(d, width=16, height=16))
    r = JRenderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=GOLDEN_DEPTH)
    r.render(2)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax2.npz")
    r.save_checkpoint(ckpt)
    r.render(2)
    return scene, ckpt, r.image()


def test_port_resumes_jax_checkpoint(jax_reference, tmp_path):
    scene, ckpt, want = jax_reference
    r = Renderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=GOLDEN_DEPTH, device="cpu")
    r.load_checkpoint(ckpt)
    assert r.state.accum_id == 2
    r.render(2)
    got = r.image()
    scale = max(float(np.abs(want).mean()), 1e-6)
    assert float(np.sqrt(((got - want) ** 2).mean())) / scale < 5e-3


def test_jax_resumes_port_checkpoint(jax_reference, tmp_path):
    scene, _, want = jax_reference
    r = Renderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=GOLDEN_DEPTH, device="cpu")
    r.render(2)
    ckpt = str(tmp_path / "port2.npz")
    r.save_checkpoint(ckpt)
    j = JRenderer(scene, width=16, height=16, mode=RendererType.PATH, path_depth=GOLDEN_DEPTH)
    j.load_checkpoint(ckpt)
    assert int(j.state.accum_id) == 2
    j.render(2)
    got = j.image()
    scale = max(float(np.abs(want).mean()), 1e-6)
    assert float(np.sqrt(((got - want) ** 2).mean())) / scale < 5e-3
    with np.load(ckpt) as z:
        assert sorted(z.files) == ["accum", "accum_id", "cam_dir_00", "cam_dir_du", "cam_dir_dv", "cam_pos"]
    with pytest.raises(ValueError, match="checkpoint"):
        Renderer(scene, width=8, height=8, device="cpu").load_checkpoint(ckpt)
