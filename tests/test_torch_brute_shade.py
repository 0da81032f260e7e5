"""The brute tier's shade gather (kernel K3's plain version) against the JAX
package, and its routing.

``engine.shade.build_surface_interaction`` is the plain version of K3
(``engine/shade_kernel.py``, ``csrc/brute_shade.cu``).  The same hits, made
with numpy from a seed, go through it and through the JAX
``engine/shade.py::build_surface_interaction`` (the one-hot gather at
Precision.HIGHEST and ``_finalize``): on the Cornell box with misses, hits
on the light triangles and hits with u + v = 1 among them, and on the
textured Cornell of ``tests/test_torch_textures.py``, whose checker floor
takes the bilinear atlas sample.  Ints and bools must be equal; floats
within rtol 1e-6 (the same f32 operations; the gather is exact in both).

On CPU tensors ``trace_closest_si`` shades through the plain version, and
``brute_shade_cuda`` refuses a CPU tensor before it builds or launches
anything.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.core.types import Hit as JHit
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine import shade as jshade
from optix_renderer_tpu.scene.device import build_device_scene as jbuild_device_scene
from optix_renderer_tpu_torch.accel.build import build_bvh
from optix_renderer_tpu_torch.core.types import Hit, Ray
from optix_renderer_tpu_torch.engine import shade as tshade
from optix_renderer_tpu_torch.engine import shade_kernel
from optix_renderer_tpu_torch.engine.renderer import bvh_inputs
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene
from optix_renderer_tpu_torch.scene.device import PACK_SLICES, build_device_scene
from tests.test_torch_textures import textured_scene  # noqa: F401  (the fixture)

torch.set_num_threads(2)

N = 4096
SEED = 20261017


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return parse_scene(write_cornell_scene(str(tmp_path_factory.mktemp("shade_cornell")), width=32, height=32))


def _hits(tri_pack: np.ndarray, seed: int):
    """(tri_id, u, v): a seeded batch over every triangle with ~10 % misses,
    a quarter of the hits on light triangles (where the scene has them)
    and ~10 % of lanes with v = 1 - u."""
    rng = np.random.default_rng(seed)
    n_tris = tri_pack.shape[0]
    lights = np.flatnonzero(tri_pack[:, PACK_SLICES["is_light"][0]] > 0.5)
    tri = rng.integers(0, n_tris, N).astype(np.int32)
    if lights.size:
        on_light = rng.random(N) < 0.25
        tri[on_light] = rng.choice(lights, on_light.sum())
    tri[rng.random(N) < 0.1] = -1
    u = rng.random(N).astype(np.float32)
    v = (rng.random(N).astype(np.float32) * (np.float32(1) - u)).astype(np.float32)
    edge = rng.random(N) < 0.1
    v[edge] = np.float32(1) - u[edge]
    t = rng.uniform(0.5, 500.0, N).astype(np.float32)
    return tri, u, v, t


def _compare(scene, seed: int):
    tds, _host = build_device_scene(scene, "cpu")
    jds = jbuild_device_scene(scene)
    tri, u, v, t = _hits(tds.tri_pack.numpy(), seed)
    assert (tri < 0).any() and (tri >= 0).any()
    assert np.any((u + v == 1.0) & (tri >= 0))
    zeros = np.zeros((N, 3), np.float32)
    got = tshade.build_surface_interaction(
        tds, Ray(torch.tensor(zeros), torch.tensor(zeros)),
        Hit(t=torch.tensor(t), tri_id=torch.tensor(tri), bary_u=torch.tensor(u), bary_v=torch.tensor(v)))
    want = jshade.build_surface_interaction(
        jds, JRay(jnp.asarray(zeros), jnp.asarray(zeros)),
        JHit(t=jnp.asarray(t), tri_id=jnp.asarray(tri), bary_u=jnp.asarray(u), bary_v=jnp.asarray(v)))
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape, f.name
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g.dtype == np.float32, f.name
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f.name)
    return got, tri


def test_matches_jax_on_cornell_hits(cornell):
    si, tri = _compare(cornell, SEED)
    hit = si.hit.numpy()
    np.testing.assert_array_equal(hit, tri >= 0)
    assert si.is_light.numpy()[hit].any() and not si.is_light.numpy()[~hit].any()
    # the miss program's fill
    assert (si.p.numpy()[~hit] == 0).all() and (si.alpha.numpy()[~hit] == 0).all()
    assert (si.material_id.numpy()[~hit] == 0).all()


def test_matches_jax_on_the_textured_cornell(textured_scene):  # noqa: F811
    tds, _host = build_device_scene(textured_scene, "cpu")
    assert tds.has_textures
    si, tri = _compare(textured_scene, SEED + 1)
    textured = tds.tri_pack.numpy()[np.maximum(tri, 0), PACK_SLICES["diffuse_tex"][0]] >= 0
    assert (textured & (tri >= 0)).sum() > 100
    d = si.diffuse.numpy()[textured & (tri >= 0)]
    assert d.max() > 0.9 and d.min() < 0.1  # both checker tones: the atlas was sampled


def test_trace_closest_si_routes_cpu_tensors_to_the_plain_version(cornell, monkeypatch):
    ds, host = build_device_scene(cornell, "cpu")
    tri_verts, kw = bvh_inputs(host)
    bvh = build_bvh(tri_verts, "cpu", **kw)
    rng = np.random.default_rng(SEED)
    o = torch.tensor(np.tile(np.float32([278.0, 273.0, -500.0]), (256, 1)))
    d = torch.tensor(rng.normal(size=(256, 3)).astype(np.float32) * [0.3, 0.3, 1.0] + [0, 0, 1], dtype=torch.float32)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    calls = []
    plain = tshade.build_surface_interaction

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached kernel K3")

    monkeypatch.setattr(tshade, "build_surface_interaction", counting)
    monkeypatch.setattr(shade_kernel, "brute_shade_cuda", no_kernel)
    active = torch.arange(256) % 3 != 0
    for kwargs in ({}, {"plain": True}, {"active": active}, {"active": active, "t_max": torch.where(active, 3e38, 0.0)}):
        si = tshade.trace_closest_si(ds, bvh, Ray(o, d), **kwargs)
        if "active" in kwargs:
            assert not si.hit[~active].any()
    assert len(calls) == 4
    assert si.hit[active].any()


def test_brute_shade_cuda_refuses_cpu_tensors(cornell, monkeypatch):
    ds, _host = build_device_scene(cornell, "cpu")

    def no_build():
        raise AssertionError("brute_shade_cuda built its library for a CPU tensor")

    monkeypatch.setattr(shade_kernel, "kernel_library", no_build)
    n = 8
    hit = Hit(t=torch.ones(n), tri_id=torch.zeros(n, dtype=torch.int32), bary_u=torch.zeros(n),
              bary_v=torch.zeros(n))
    with pytest.raises(ValueError, match="CUDA"):
        shade_kernel.brute_shade_cuda(ds, hit)
    assert shade_kernel.LAUNCHES["brute_shade"] == 0


def test_shading_another_device_raises(cornell):
    with pytest.raises(ValueError, match="no shading for device"):
        tshade._brute_shade(torch.device("meta"), False)
