"""Three mesh lights of different emission (``write_cornell3_scene``) in the
port against the JAX renderer, mirroring tests/integration/test_multilight.py:
the light lists equal, the LTC image carrying every light's color and
within the goldens' LTC tolerance (relative RMSE 1e-4) of the JAX image,
and PATH depth 2 within the goldens' PATH tolerance (5e-3), both renderers
on the same scene files and the same RNG streams.
"""

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.modes import RendererType as JRendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell3_scene

torch.set_num_threads(2)

TOL = {RendererType.LTC_BASELINE: 1e-4, RendererType.PATH: 5e-3}  # tests/goldens/test_goldens.py


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_cornell3_scene(str(tmp_path_factory.mktemp("cornell3")))


def _rmse(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


def test_three_mesh_lights(scene_path):
    r = Renderer(parse_scene(scene_path), width=16, height=16, mode=RendererType.MASK, device="cpu")
    jr = JRenderer(jparse_scene(scene_path), width=16, height=16, mode=JRendererType.MASK)
    ds, jds = r.device_scene, jr.device_scene
    assert ds.num_lights == 6  # 3 quads x 2 triangles
    assert ds.mesh_light_tri_idx.shape[0] == 3
    assert len(np.unique(ds.light_emit.numpy(), axis=0)) == 3  # distinct emissions
    for f in ("light_v1", "light_v2", "light_v3", "light_normal", "light_emit", "light_area",
              "mesh_light_tri_idx", "mesh_light_tri_count"):
        np.testing.assert_array_equal(getattr(ds, f).numpy(), np.asarray(getattr(jds, f)), err_msg=f)


@pytest.mark.parametrize("mode,res,frames", [(RendererType.LTC_BASELINE, 64, 1), (RendererType.PATH, 32, 2)],
                         ids=["ltc", "path"])
def test_render_matches_jax(scene_path, mode, res, frames):
    r = Renderer(parse_scene(scene_path), width=res, height=res, mode=mode, path_depth=2, device="cpu")
    r.render(frames)
    jr = JRenderer(jparse_scene(scene_path), width=res, height=res, mode=JRendererType(int(mode)), path_depth=2)
    jr.render(frames)
    img, want = r.image(), np.asarray(jr.image())
    assert np.isfinite(img).all() and img.max() > 0
    assert _rmse(img, want) < TOL[mode]
    if mode == RendererType.LTC_BASELINE:
        # every channel receives energy on the floor (bottom rows): the warm,
        # the blue and the green light all reach it
        floor = img[:24]
        for c, name in ((0, "warm"), (1, "green"), (2, "blue")):
            assert (floor[..., c] > 1e-4).any(), f"no {name} light contribution"
