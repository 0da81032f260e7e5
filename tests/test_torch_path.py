"""The port's ``path_color`` against the JAX one at 32^2, depth 4, on the
procedural Cornell box: the same primary rays, SurfaceInteraction, RNG
state, DeviceScene and BVH go into both.

Tolerance: relative RMSE <= 5e-3 (``tests/goldens/test_goldens.py``'s path
bound), because a last-bit difference can flip a lobe choice or a
hemisphere test and change a few whole paths; the per-bounce
alive/shadow/bounce counts within 0.1 % per entry; the RNG state after the
loop bit-exact (every lane draws the same number of uniforms).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel.build import build_bvh as jbuild_bvh
from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine.shade import trace_closest_si as jtrace_closest_si
from optix_renderer_tpu.integrators import path as jpath
from optix_renderer_tpu.scene import device as jdevice
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu_torch.accel.build import bvh_from_numpy
from optix_renderer_tpu_torch.core.types import Ray, SurfaceInteraction
from optix_renderer_tpu_torch.integrators import path as tpath
from optix_renderer_tpu_torch.scene.device import device_scene_from_numpy

torch.set_num_threads(2)

RES, DEPTH = 32, 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cornell_path"))
    scene = parse_scene(procedural.write_cornell_scene(d, width=RES, height=RES))
    jds, host = jdevice.build_device_scene(scene, return_host=True)
    tri_idx = host["tri_index"]
    norms = host["normals"][tri_idx].sum(axis=1)
    norms /= np.maximum(np.linalg.norm(norms, axis=-1, keepdims=True), 1e-20)
    arrs = jbuild_bvh(host["vertices"][tri_idx], tri_normal=norms, tri_mesh=host["tri_mesh"], _as_arrays=True)
    jbvh = jbuild_bvh(host["vertices"][tri_idx], tri_normal=norms, tri_mesh=host["tri_mesh"])
    fields = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds) if f.name != "textures"}
    fields["textures"] = {k: np.asarray(getattr(jds.textures, k)) for k in ("pixels", "offset", "width", "height")}
    cam = scene.cameras[0]
    jcam = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, RES, RES)
    jpath_color = jax.jit(functools.partial(jpath.path_color, max_depth=DEPTH))
    return dict(jds=jds, jbvh=jbvh, jcam=jcam, jpath_color=jpath_color,
                tds=device_scene_from_numpy(fields, "cpu"), tbvh=bvh_from_numpy(arrs, "cpu"))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("accum_id", [0, 5])
def test_path_color_matches_jax(setup, accum_id):
    lin = jnp.arange(RES * RES, dtype=jnp.uint32)
    rstate = jrng.make_rng(accum_id + 10007, lin)
    rstate, ju = jrng.lcg_randomf(rstate)
    rstate, jv = jrng.lcg_randomf(rstate)
    rays = jcamera.primary_rays(setup["jcam"], RES, RES, ju, jv)
    si, _ = jtrace_closest_si(setup["jds"], setup["jbvh"], rays)
    want, want_rng, want_counts, _ = setup["jpath_color"](setup["jds"], setup["jbvh"], rays, si, rstate)

    tsi = SurfaceInteraction(**{f.name: _t(getattr(si, f.name)) for f in dataclasses.fields(si)})
    trng = _t(np.asarray(rstate).astype(np.int64))
    got, got_rng, got_counts = tpath.path_color(
        setup["tds"], setup["tbvh"], Ray(_t(rays.origin), _t(rays.direction)), tsi, trng, max_depth=DEPTH)

    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    rmse = float(np.sqrt(((got.numpy() - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)
    assert rmse <= 5e-3, f"relative RMSE {rmse:.3g}"
    np.testing.assert_array_equal(got_rng.numpy().astype(np.uint32), np.asarray(want_rng))
    want_counts = np.asarray(want_counts, np.int64)
    assert got_counts.shape == (DEPTH, 3) and got_counts.device == got.device
    assert want_counts[:, 1:].sum() > 0
    np.testing.assert_array_less(np.abs(got_counts.numpy() - want_counts), 1e-3 * want_counts + 1e-9)


def test_light_gather_and_pdf_conversion(setup):
    rng = np.random.default_rng(4)
    L = setup["tds"].num_lights
    lidx = rng.integers(0, L, size=256).astype(np.int32)
    want = jpath.gather_light_attrs(setup["jds"], jnp.asarray(lidx))
    got = tpath.gather_light_attrs(setup["tds"], torch.as_tensor(lidx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # an index gather is exact
    pdf, d2, cos_t = (rng.uniform(-1.0, 2.0, size=256).astype(np.float32) for _ in range(3))
    cos_t[:16] = 0.0
    want = jpath.pdf_area_to_solid_angle(jnp.asarray(pdf), jnp.asarray(d2), jnp.asarray(cos_t))
    got = tpath.pdf_area_to_solid_angle(*(torch.as_tensor(a) for a in (pdf, d2, cos_t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
