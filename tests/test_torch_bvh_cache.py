"""The port's content-addressed BVH cache (``accel.build.build_bvh_cached``)
on the CPU.

Held: one file per geometry, and a warm load equal to a build in every
tensor (the JAX ``test_bvh_cache_roundtrip`` case, tests/unit/test_accel.py);
other geometry, normals, mesh ids or shade rows give another file; the
cluster tier (more than 4096 triangles, with ``tri_attr``) round-trips; a
JAX cache and a port cache in one directory each load their own entry;
``Renderer(bvh_cache_dir=)`` gives the same image cold and warm, and the
warm one builds nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel.build import build_bvh as jbuild_bvh
from optix_renderer_tpu.accel.build import build_bvh_cached as jbuild_bvh_cached
from optix_renderer_tpu_torch.accel import build
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene import parse_scene, write_terrain_scene

torch.set_num_threads(2)


def _entries(d):
    return sorted(p.name for p in d.glob("torch-bvh-*.npz"))


def _assert_bvh_equal(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def test_bvh_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    tv = rng.random((600, 3, 3)).astype(np.float32)
    d = tmp_path / "bake"

    cold = build.build_bvh_cached(str(d), tv, "cpu")
    assert len(_entries(d)) == 1
    warm = build.build_bvh_cached(str(d), tv, "cpu")
    ref = build.build_bvh(tv, "cpu")
    _assert_bvh_equal(cold, ref)
    _assert_bvh_equal(warm, ref)

    # other geometry, normals or mesh ids are other entries, never a stale one
    tv2 = tv.copy()
    tv2[0, 0, 0] += 1.0
    other = build.build_bvh_cached(str(d), tv2, "cpu")
    build.build_bvh_cached(str(d), tv, "cpu", tri_normal=np.ones((600, 3), np.float32))
    build.build_bvh_cached(str(d), tv, "cpu", tri_mesh=np.zeros(600, np.int32))
    assert len(_entries(d)) == 4
    assert not torch.equal(other.tri_v0, warm.tri_v0)
    assert not list(d.glob("*.tmp*"))  # written through a temporary name, then renamed


def test_cluster_tier_roundtrip(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    T = build.BRUTE_MAX_TRIS + 904
    tv = rng.random((T, 3, 3)).astype(np.float32) * 100.0
    n_corner = rng.standard_normal((T, 3, 3)).astype(np.float32)
    uv_corner = rng.random((T, 3, 2)).astype(np.float32)
    mesh = rng.integers(0, 5, T).astype(np.int32)
    v0 = tv[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(tv[:, 1] - v0, tv[:, 2] - v0), axis=-1)
    kw = dict(tri_normal=n_corner.sum(axis=1), tri_mesh=mesh, tri_attr=build.pack_attr_tab(n_corner, uv_corner,
                                                                                             mesh, area))
    ref = build.build_bvh(tv, "cpu", **kw)
    assert ref.clustered
    cold = build.build_bvh_cached(str(tmp_path), tv, "cpu", **kw)

    def no_build(*a, **k):
        raise AssertionError("a warm cache must not build")

    monkeypatch.setattr(build, "build_bvh_arrays", no_build)
    warm = build.build_bvh_cached(str(tmp_path), tv, "cpu", **kw)
    _assert_bvh_equal(cold, ref)
    _assert_bvh_equal(warm, ref)
    # the shade rows are part of the key
    nrm, uvm = kw["tri_attr"]
    key = build.bvh_cache_key(tv, **kw)
    assert build.bvh_cache_key(tv, **{**kw, "tri_attr": (nrm, uvm + 1.0)}) != key


def test_jax_and_port_entries_share_a_directory(tmp_path):
    """The port's tables have another layout: its entries have their own
    name (``torch-bvh-<sha1>.npz``), so neither package reads the other's."""
    rng = np.random.default_rng(9)
    tv = rng.random((300, 3, 3)).astype(np.float32)
    d = str(tmp_path)
    jbuild_bvh_cached(d, tv)
    port = build.build_bvh_cached(d, tv, "cpu")
    assert len(list(tmp_path.glob("bvh-*.npz"))) == 1 and len(_entries(tmp_path)) == 1
    jwarm = jbuild_bvh_cached(d, tv)
    pwarm = build.build_bvh_cached(d, tv, "cpu")
    jref = jbuild_bvh(tv)
    for f in ("tri_tab", "tri_v0", "prim_id", "cluster_min"):
        np.testing.assert_array_equal(np.asarray(getattr(jwarm, f)), np.asarray(getattr(jref, f)))
    _assert_bvh_equal(pwarm, port)
    _assert_bvh_equal(pwarm, build.build_bvh(tv, "cpu"))
    assert len(list(tmp_path.iterdir())) == 2


def test_renderer_cold_and_warm_cache_render_the_same(tmp_path, monkeypatch):
    mode = RendererType.NORMALS
    scene = parse_scene(write_terrain_scene(str(tmp_path / "terrain"), grid=60, width=16, height=16))
    cache = tmp_path / "cache"
    cold = Renderer(scene, width=16, height=16, mode=mode, device="cpu", bvh_cache_dir=str(cache))
    assert cold.bvh.clustered and len(_entries(cache)) == 1
    cold.render(1)
    monkeypatch.setattr(build, "build_bvh_arrays", lambda *a, **k: pytest.fail("the warm renderer built"))
    warm = Renderer(scene, width=16, height=16, mode=mode, device="cpu", bvh_cache_dir=str(cache))
    warm.render(1)
    _assert_bvh_equal(warm.bvh, cold.bvh)
    np.testing.assert_array_equal(warm.image(), cold.image())
    assert np.abs(cold.image()).mean() > 0
