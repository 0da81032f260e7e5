"""Shading-side modules of the port against the JAX package, on the same
numpy inputs: BSDF, material, frames, triangle sampling, primary rays and
the hit shading stage (on Cornell primary hits, with the JAX DeviceScene
carried across by ``device_scene_from_numpy``).

Tolerance rtol 1e-5 / atol 1e-6: the same f32 operations, differing only
in the order of some sums and in the last bit of sqrt/sin/cos.  Masks and
integer fields must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel.build import build_bvh as jbuild_bvh
from optix_renderer_tpu.accel.traverse import trace_closest as jtrace_closest
from optix_renderer_tpu.core import math as jmath
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine import shade as jshade
from optix_renderer_tpu.scene import device as jdevice
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu.shading import bsdf as jbsdf
from optix_renderer_tpu.shading import material as jmaterial
from optix_renderer_tpu_torch.core import math as tmath
from optix_renderer_tpu_torch.core.types import Hit, Ray
from optix_renderer_tpu_torch.engine import camera as tcamera
from optix_renderer_tpu_torch.engine import shade as tshade
from optix_renderer_tpu_torch.scene.device import device_scene_from_numpy
from optix_renderer_tpu_torch.shading import bsdf as tbsdf
from optix_renderer_tpu_torch.shading import material as tmaterial

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 2048


def _same(got, want):
    """Compare a port output (tensor or tuple) with the JAX one."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)


def _unit(rng, n, upper=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v


@pytest.fixture(scope="module")
def local():
    """Local-frame directions (a quarter below the horizon), roughness,
    base colors and uniforms."""
    rng = np.random.default_rng(11)
    wi, wo = _unit(rng, N), _unit(rng, N)
    wo[: N // 4 * 3, 2] = np.abs(wo[: N // 4 * 3, 2])
    return dict(
        wi=wi, wo=wo,
        alpha=rng.uniform(0.01, 1.0, size=N).astype(np.float32),
        base=rng.uniform(0.0, 1.0, size=(N, 3)).astype(np.float32),
        u1=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
        u2=rng.uniform(0.0, 1.0, size=N).astype(np.float32),
    )


def _call(name_mod_pairs, fn, args):
    (jmod, tmod) = name_mod_pairs
    want = getattr(jmod, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(tmod, fn)(*[torch.as_tensor(a) for a in args])
    _same(got, want)


@pytest.mark.parametrize("fn,keys", [
    ("diffuse_lambert", ("wi", "wo", "base")),
    ("microfacet_reflection_ggx", ("wi", "wo", "base", "alpha")),
    ("pdf_cosine_hemisphere", ("wi", "wo")),
    ("sample_cosine_hemisphere", ("u1", "u2")),
    ("pdf_ggx_vndf_reflection", ("wi", "wo", "alpha")),
    ("g1_smith_ggx", ("wo", "alpha")),
    ("g2_smith_height_correlated_ggx", ("wi", "wo", "alpha")),
    ("d_ggx", ("wi", "alpha")),
    ("tan_theta2", ("wo",)),
])
def test_bsdf(local, fn, keys):
    _call((jbsdf, tbsdf), fn, [local[k] for k in keys])


def test_bsdf_vndf_sample_and_fresnel(local):
    _call((jbsdf, tbsdf), "sample_ggx_vndf", [np.abs(local["wo"]), local["alpha"], local["u1"], local["u2"]])
    _call((jbsdf, tbsdf), "fr_schlick", [np.abs(local["wi"][:, 2]), local["base"]])


@pytest.mark.parametrize("fn,keys", [
    ("evaluate", ("wi", "wo", "base", "alpha")),
    ("pdf", ("wi", "wo", "base", "alpha")),
    ("compute_lobe_probabilities", ("wo", "base")),
])
def test_material(local, fn, keys):
    _call((jmaterial, tmaterial), fn, [local[k] for k in keys])


@pytest.mark.parametrize("horizon", [False, True])
def test_material_sample_direction(local, horizon):
    """wi and valid against JAX.  The returned pdf is checked against the
    JAX pdf of the port's own wi: at roughness ~0.02 the GGX pdf near its
    peak turns a last-bit difference in wi into ~1e-4 relative, which is
    the function's conditioning, not a difference of the port.
    ``horizon``: cos(wo) == 0 must pick the +1 hemisphere (the sign(0) guard)."""
    wo = local["wo"].copy()
    if horizon:
        wo[:64, 2] = 0.0
        wo[:64] /= np.linalg.norm(wo[:64], axis=-1, keepdims=True)
    args = [wo, local["u1"], local["u2"], local["base"], local["alpha"]]
    jwi, _, jvalid = jmaterial.sample_direction(*[jnp.asarray(a) for a in args])
    wi, pdf, valid = tmaterial.sample_direction(*[torch.as_tensor(a) for a in args])
    _same((wi, valid), (jwi, jvalid))
    want_pdf = jmaterial.pdf(jnp.asarray(wi.numpy()), jnp.asarray(wo), jnp.asarray(local["base"]),
                             jnp.asarray(local["alpha"]))
    _same(pdf, want_pdf)


def test_orthonormal_basis_and_apply_mat(local):
    n = local["wi"].copy()
    n[:8] = [0.0, 0.0, -1.0]  # the singular branch
    n[8:16] = [0.0, 0.0, 1.0]
    _call((jmath, tmath), "orthonormal_basis", [n])
    to_local, _ = jmath.orthonormal_basis(jnp.asarray(n))
    _call((jmath, tmath), "apply_mat", [np.array(to_local), local["wo"]])
    _call((jmath, tmath), "normalize", [local["base"] + 0.1])


def test_triangle_helpers():
    rng = np.random.default_rng(5)
    v1, v2, v3 = (rng.normal(size=(N, 3)).astype(np.float32) * 100 for _ in range(3))
    u1, u2 = (rng.uniform(size=N).astype(np.float32) for _ in range(2))
    _call((jmath, tmath), "sample_point_on_triangle", [v1, v2, v3, u1, u2])
    _call((jmath, tmath), "triangle_area", [v1, v2, v3])
    pdf_a, pdf_b = (rng.uniform(0.0, 3.0, size=N).astype(np.float32) for _ in range(2))
    want = jmath.balance_heuristic(1, jnp.asarray(pdf_a), 1, jnp.asarray(pdf_b))
    _same(tmath.balance_heuristic(1, torch.as_tensor(pdf_a), 1, torch.as_tensor(pdf_b)), want)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    """The procedural Cornell box at 48x32: JAX DeviceScene + brute BVH,
    the port's DeviceScene carried across, and jittered primary rays."""
    d = str(tmp_path_factory.mktemp("cornell_shading"))
    scene = parse_scene(procedural.write_cornell_scene(d, width=48, height=32))
    jds, host = jdevice.build_device_scene(scene, return_host=True)
    jbvh = jbuild_bvh(host["vertices"][host["tri_index"]])
    fields = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds) if f.name != "textures"}
    fields["textures"] = {k: np.asarray(getattr(jds.textures, k)) for k in ("pixels", "offset", "width", "height")}
    tds = device_scene_from_numpy(fields, "cpu")
    cam = scene.cameras[0]
    rng = np.random.default_rng(2)
    ju, jv = (rng.uniform(size=48 * 32).astype(np.float32) for _ in range(2))
    return dict(scene=scene, jds=jds, jbvh=jbvh, tds=tds, cam=cam, ju=ju, jv=jv)


def test_device_scene_carried_across(cornell):
    jds, tds = cornell["jds"], cornell["tds"]
    for f in dataclasses.fields(jds):
        if f.name == "textures":
            continue
        w, g = np.asarray(getattr(jds, f.name)), getattr(tds, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert tds.num_tris == jds.num_tris and tds.num_lights == jds.num_lights


def test_primary_rays(cornell):
    cam = cornell["cam"]
    jc = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, 48, 32)
    tc = tcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, 48, 32, "cpu")
    for f in ("pos", "dir_00", "dir_du", "dir_dv"):
        g = getattr(tc, f)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jc, f)))
    jr = jcamera.primary_rays(jc, 48, 32, jnp.asarray(cornell["ju"]), jnp.asarray(cornell["jv"]))
    tr = tcamera.primary_rays(tc, 48, 32, torch.as_tensor(cornell["ju"]), torch.as_tensor(cornell["jv"]))
    assert tr.origin.is_contiguous() and tr.origin.stride() == (3, 1)
    _same((tr.origin, tr.direction), (jr.origin, jr.direction))


def test_build_surface_interaction_on_cornell_hits(cornell):
    cam = cornell["cam"]
    jc = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, 48, 32)
    jr = jcamera.primary_rays(jc, 48, 32, jnp.asarray(cornell["ju"]), jnp.asarray(cornell["jv"]))
    # steer a band of rays out of the open front of the box: misses
    d = np.asarray(jr.direction).copy()
    d[:100] = [0.0, 0.0, -1.0]
    jr = JRay(origin=jr.origin, direction=jnp.asarray(d))
    jhit = jtrace_closest(cornell["jbvh"], jr)
    assert (np.asarray(jhit.tri_id) < 0).sum() >= 100 and (np.asarray(jhit.tri_id) >= 0).sum() > 1000
    want = jshade.build_surface_interaction(cornell["jds"], jr, jhit)
    hit = Hit(*(torch.tensor(np.asarray(a)) for a in (jhit.t, jhit.tri_id, jhit.bary_u, jhit.bary_v)))
    rays = Ray(torch.tensor(np.asarray(jr.origin)), torch.as_tensor(d))
    got = tshade.build_surface_interaction(cornell["tds"], rays, hit)
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))
