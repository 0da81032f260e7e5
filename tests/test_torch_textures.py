"""Texture sampling in the port against the JAX package, mirroring
tests/unit/test_textures.py: ``sample_bilinear`` (CUDA tex2D LINEAR + CLAMP,
texel centers at i + 0.5) on an atlas of three textures of different sizes,
uv in and out of [0, 1], against the JAX function and the scalar oracle
(rtol = atol = 1e-5); the atlas the port packs equal to the JAX one; and the
shading's uv wrap |fmod(uv, 1)| (hit_miss.cuh:34-35) on a checker floor
whose u runs to 2: u and u + 1 sample the same texels, in both packages.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.core.types import Hit as JHit
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine.shade import build_surface_interaction as jbuild_si
from optix_renderer_tpu.scene.device import build_device_scene as jbuild_device_scene
from optix_renderer_tpu.scene.device import build_texture_atlas
from optix_renderer_tpu.scene.obj_loader import Texture
from optix_renderer_tpu.scene.textures import sample_bilinear as jsample_bilinear
from optix_renderer_tpu_torch.core.types import Hit, Ray
from optix_renderer_tpu_torch.engine.shade import build_surface_interaction
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene
from optix_renderer_tpu_torch.scene.device import TextureAtlas, build_device_scene
from optix_renderer_tpu_torch.scene.textures import sample_bilinear

torch.set_num_threads(2)


def bilinear_oracle(pix, u, v):
    """Scalar CUDA tex2D LINEAR+CLAMP reference (texel centers at i+0.5)."""
    h, w = pix.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0

    def cl(i, n):
        return min(max(i, 0), n - 1)

    t00 = pix[cl(y0, h), cl(x0, w)]
    t01 = pix[cl(y0, h), cl(x0 + 1, w)]
    t10 = pix[cl(y0 + 1, h), cl(x0, w)]
    t11 = pix[cl(y0 + 1, h), cl(x0 + 1, w)]
    return (t00 * (1 - fx) + t01 * fx) * (1 - fy) + (t10 * (1 - fx) + t11 * fx) * fy


def test_bilinear_matches_jax_and_the_oracle():
    rng = np.random.default_rng(3)
    texs = [Texture(pixels=rng.random(shape).astype(np.float32)) for shape in ((7, 5, 4), (16, 16, 4), (3, 9, 4))]
    jatlas = build_texture_atlas(texs)
    atlas = TextureAtlas(**{k: torch.tensor(np.asarray(getattr(jatlas, k))) for k in
                            ("pixels", "offset", "width", "height")})
    n = 300
    tid = rng.integers(0, 3, n).astype(np.int32)
    u = rng.uniform(-0.2, 1.2, n).astype(np.float32)  # incl. out-of-range (clamp)
    v = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    got = sample_bilinear(atlas, torch.tensor(tid), torch.tensor(u), torch.tensor(v)).numpy()
    want = np.asarray(jsample_bilinear(jatlas, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for i in range(n):
        np.testing.assert_allclose(got[i], bilinear_oracle(texs[tid[i]].pixels, float(u[i]), float(v[i])),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.fixture(scope="module")
def textured_scene(tmp_path_factory):
    """A checker-textured floor quad whose u wraps twice (the JAX test's
    fixture), as the scene's only surface geometry."""
    from PIL import Image

    d = str(tmp_path_factory.mktemp("texscene"))
    write_cornell_scene(d, width=64, height=64)
    checker = np.zeros((8, 8, 3), np.uint8)
    checker[::2, ::2] = 255
    checker[1::2, 1::2] = 255
    Image.fromarray(checker).save(os.path.join(d, "checker.png"))
    with open(os.path.join(d, "floor.mtl"), "w") as f:
        f.write("newmtl texfloor\nKd 1.0 1.0 1.0\nNs 0.4\nmap_Kd checker.png\n")
    with open(os.path.join(d, "floor.obj"), "w") as f:
        f.write("mtllib floor.mtl\n"
                "v 0 0.01 0\nv 556 0.01 0\nv 556 0.01 559\nv 0 0.01 559\n"
                "vn 0 1 0\n"
                "vt 0 0\nvt 2 0\nvt 2 1\nvt 0 1\n"  # u wraps twice (abs-fmod)
                "usemtl texfloor\n"
                "f 1/1/1 2/2/1 3/3/1 4/4/1\n")
    with open(os.path.join(d, "scene.json")) as f:
        cfg = json.load(f)
    cfg["surface_geometry"] = "floor.obj"
    with open(os.path.join(d, "scene.json"), "w") as f:
        json.dump(cfg, f)
    return parse_scene(os.path.join(d, "scene.json"))


def test_atlas_matches_jax(textured_scene):
    ds, _host = build_device_scene(textured_scene, "cpu")
    jds = jbuild_device_scene(textured_scene)
    assert ds.has_textures and int(ds.mesh_diffuse_tex.max()) >= 0
    for k in ("pixels", "offset", "width", "height"):
        np.testing.assert_array_equal(getattr(ds.textures, k).numpy(), np.asarray(getattr(jds.textures, k)),
                                      err_msg=k)


def test_uv_wrap_abs_fmod(textured_scene):
    """uv = |fmod(uv, 1)|: on the floor's triangle 0 (vt (0,0) (2,0) (2,1))
    u = 2 * bary_u at bary_v = 0, so bary_u + 0.5 is u + 1: the same texels."""
    ds, _host = build_device_scene(textured_scene, "cpu")
    jds = jbuild_device_scene(textured_scene)
    n = 8
    bu = np.linspace(0.05, 0.45, n).astype(np.float32)
    rays = Ray(origin=torch.zeros((n, 3)), direction=torch.ones((n, 3)))
    jrays = JRay(origin=jnp.zeros((n, 3), jnp.float32), direction=jnp.ones((n, 3), jnp.float32))
    diffuse = []
    for b in (bu, bu + 0.5):
        si = build_surface_interaction(ds, rays, Hit(t=torch.ones(n), tri_id=torch.zeros(n, dtype=torch.int32),
                                                     bary_u=torch.tensor(b), bary_v=torch.zeros(n)))
        jsi = jbuild_si(jds, jrays, JHit(t=jnp.ones(n, jnp.float32), tri_id=jnp.zeros(n, jnp.int32),
                                         bary_u=jnp.asarray(b), bary_v=jnp.zeros(n, jnp.float32)))
        np.testing.assert_allclose(si.diffuse.numpy(), np.asarray(jsi.diffuse), rtol=1e-5, atol=1e-5)
        diffuse.append(si.diffuse.numpy())
    np.testing.assert_allclose(diffuse[0], diffuse[1], atol=1e-5)
    assert diffuse[0].max() > 0.9 and diffuse[0].min() < 0.1  # both checker tones
