"""The port's cluster tier (``accel.build`` cluster half, ``accel.cluster``,
the plain versions of kernels B3 and B4 and the winner-attribute gather in
``accel.cluster_trace``, and the fused shading) against the JAX package on
the same inputs.  The port's build orders the cluster tier by a median
split, the JAX package's by Morton runs: the build products are held equal
up to that order, and every kernel comparison runs the port on the JAX
build's tables (``tests/torch_jax_tables.py``).  The port
walks; the JAX package culls into lists, and its culls are forced into
each of their regimes (single level, two level, a binding supercluster
cap whose checked fallback runs) to show that the walk returns what the
list path returns in every one.

The JAX side runs its Pallas kernels with ``interpret=True``, as
``tests/unit/test_pallas_cluster.py`` does; each such call costs seconds on
the CPU, so every reference is computed once per module.

Tolerances:
* build products: equal, row for row through the two orders; t bounds and
  corridor keys: equal (the same f32 operations in the same order);
* B3: the same winner (cluster id and local triangle id) on at least
  99.9 % of lanes, with the packed keys at most one quantum of t apart,
  and equal keys on at least 99 %: XLA's CPU lowering contracts a*b + c*d
  into fused multiply-adds (on 25 % of random float32 inputs it differs
  from the uncontracted product in the last bit), while the port rounds
  each operation as the CUDA kernel built with --fmad=false does, so a t
  near a multiple of the key's 64-ulp quantum can land on either side;
  decoded t within rtol 1e-4 / atol 1e-3 of the brute-force oracle
  (tests/unit/test_pallas_cluster.py);
* B4 and the winner-attribute gather: equal on every lane;
* fused shading: rtol 1e-5 / atol 1e-6 (tests/test_torch_shading.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel import pallas_cluster as pc
from optix_renderer_tpu.accel.traverse import intersect_brute
from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine import shade as jshade
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.accel import build as tbuild
from optix_renderer_tpu_torch.accel import cluster
from optix_renderer_tpu_torch.accel import cluster_trace as ct
from optix_renderer_tpu_torch.accel import traverse as ttraverse
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine import shade as tshade
from optix_renderer_tpu_torch.engine import shade_kernel
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer, bvh_inputs
from optix_renderer_tpu_torch.scene.config import parse_scene
from optix_renderer_tpu_torch.scene.device import build_device_scene
from tests.torch_jax_tables import jax_tables

torch.set_num_threads(2)

B3_AGREE_MIN = 0.999
B3_KEY_EQUAL_MIN = 0.99
T_TOL = dict(rtol=1e-4, atol=1e-3)
SHADE_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.tensor(np.asarray(a))


def _pair(scene_path: str, width: int, height: int):
    """(JAX Renderer, port Renderer on the CPU, the JAX build's tables as a
    port BVH) of one scene: the two packages' trace tables and device
    scenes."""
    jr = JRenderer(jparse_scene(scene_path), width=width, height=height, mode=RendererType.MASK)
    tr = Renderer(parse_scene(scene_path), width=width, height=height, mode=RendererType.MASK, device="cpu")
    return jr, tr, jax_tables(jr.bvh)


def _primaries(jr, w: int, h: int):
    lin = jnp.arange(w * h, dtype=jnp.uint32)
    st = jrng.make_rng(10007, lin)
    st, ju = jrng.lcg_randomf(st)
    st, jv = jrng.lcg_randomf(st)
    return jcamera.primary_rays(jr.state.camera, w, h, ju, jv, lin=lin)


def _random_rays(jbvh, n: int, seed: int, above: float | None):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(jbvh.cluster_min.min(axis=0)), np.asarray(jbvh.cluster_max.max(axis=0))
    o = lo + rng.random((n, 3), np.float32) * (hi - lo)
    if above is not None:
        o[:, 1] = hi[1] * above
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return JRay(origin=jnp.asarray(o, jnp.float32), direction=jnp.asarray(d, jnp.float32))


def _assert_same_winners(key, cid, wkey, wcid) -> None:
    key, cid, wkey, wcid = (np.asarray(a) for a in (key, cid, wkey, wcid))
    winner = (cid == wcid) & ((key & 63) == (wkey & 63)) & (np.abs((key >> 6) - (wkey >> 6)) <= 1)
    assert winner.mean() >= B3_AGREE_MIN, winner.mean()
    assert ((key == wkey) & (cid == wcid)).mean() >= B3_KEY_EQUAL_MIN


def _tray(jrays) -> Ray:
    return Ray(origin=_t(jrays.origin), direction=_t(jrays.direction))


def _brute_ids(jbvh, jrays, t_max=3.0e38):
    tris = jnp.stack([jbvh.tri_v0, jbvh.tri_v0 + jbvh.tri_e1, jbvh.tri_v0 + jbvh.tri_e2], axis=1)
    want = intersect_brute(tris, jrays, t_max=t_max)
    ids = np.asarray(want.tri_id)
    return np.where(ids >= 0, np.asarray(jbvh.prim_id)[np.maximum(ids, 0)], -1), np.asarray(want.t)


@pytest.fixture(scope="module")
def terrain(tmp_path_factory):
    """Grid-60 terrain (~7k triangles, 110 clusters) at 64x64, with the JAX
    coherent trace of its primaries (interpret mode) and B5 on its winners."""
    path = procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain60")), grid=60, width=64, height=64)
    jr, tr, jt = _pair(path, 64, 64)
    jrays = _primaries(jr, 64, 64)
    jb = jr.bvh
    key, cid, t_eff, stats, (cids, counts) = pc.trace_closest_clusters_packed(
        jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays, return_lists=True, interpret=True)
    cols, ok = pc.fetch_winner_attrs(jb.shade_gtab, cids, counts, key, cid, jrays.origin.shape[0], interpret=True)
    assert bool(ok)
    return dict(jr=jr, tr=tr, jt=jt, jrays=jrays, key=np.asarray(key), cid=np.asarray(cid), t_eff=np.asarray(t_eff),
                cols=np.asarray(cols))


@pytest.fixture(scope="module")
def terrain100(tmp_path_factory):
    """Grid-100 terrain (~20k triangles, 310 clusters) at 32x32: enough
    clusters for a list cap of 128 to overflow."""
    path = procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain100")), grid=100, width=32,
                                          height=32)
    return _pair(path, 32, 32)


def test_build_products_match_jax(terrain):
    """The port's products are the JAX package's rows in the port's order:
    ``rows`` maps each of the port's slots to the JAX slot of the same
    triangle; each cluster box is the box of its own 64 rows."""
    jb, tb = terrain["jr"].bvh, terrain["tr"].bvh
    assert tb.clustered and tb.num_tris > 4096
    C, T = tb.num_clusters, tb.num_tris
    assert tb.tri_tab.shape == (C * 64, 16) and C == jb.cluster_min.shape[0]
    jslot = np.empty(T, np.int64)
    jslot[np.asarray(jb.prim_id)] = np.arange(T)
    rows = jslot[tb.prim_id.numpy()]
    for name in ("tri_v0", "tri_e1", "tri_e2", "prim_id"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))[rows], err_msg=name)
    np.testing.assert_array_equal(tb.shade_a.numpy()[:T], np.asarray(jb.shade_tab[0])[rows])
    np.testing.assert_array_equal(tb.shade_b.numpy()[:T], np.asarray(jb.shade_tab[1])[rows])
    np.testing.assert_array_equal(tb.shade_a.numpy()[T:], np.asarray(jb.shade_tab[0])[T:])
    np.testing.assert_array_equal(tb.shade_b.numpy()[T:], np.asarray(jb.shade_tab[1])[T:])
    # the flat table is the JAX grouped table regrouped (its column 15
    # carries the cluster bounds there), row for row
    flat = tbuild.flat_from_grouped(np.asarray(jb.tri_tab))
    np.testing.assert_array_equal(tb.tri_tab.numpy()[:T, :15], flat[rows, :15])
    np.testing.assert_array_equal(tb.tri_tab.numpy()[T:, :15], flat[T:, :15])
    # and serves as the decode's geometry table (JAX geom_tab, columns 0-9)
    np.testing.assert_array_equal(tb.tri_tab.numpy()[:T, :10], np.asarray(jb.geom_tab)[rows, :10])
    assert (tb.tri_tab[T:, 9] == -1.0).all()
    tri_verts = bvh_inputs(build_device_scene(terrain["tr"].scene, torch.device("cpu"))[1])[0]
    lo = np.full((C * 64, 3), np.inf, np.float32)
    hi = np.full((C * 64, 3), -np.inf, np.float32)
    lo[:T], hi[:T] = tri_verts.min(axis=1)[tb.prim_id.numpy()], tri_verts.max(axis=1)[tb.prim_id.numpy()]
    np.testing.assert_array_equal(tb.cluster_min.numpy(), lo.reshape(C, 64, 3).min(axis=1))
    np.testing.assert_array_equal(tb.cluster_max.numpy(), hi.reshape(C, 64, 3).max(axis=1))


def test_bvh_from_jax_arrays(terrain):
    """The JAX package's build products carry across as they are."""
    jb = terrain["jr"].bvh
    carried = jax_tables(jb)
    flat = tbuild.flat_from_grouped(np.asarray(jb.tri_tab))
    np.testing.assert_array_equal(carried.tri_tab.numpy()[:, :15], flat[:, :15])
    for name in ("cluster_min", "cluster_max", "tri_v0", "tri_e1", "tri_e2", "prim_id"):
        np.testing.assert_array_equal(getattr(carried, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(carried.shade_a.numpy(), np.asarray(jb.shade_tab[0]))
    np.testing.assert_array_equal(carried.shade_b.numpy(), np.asarray(jb.shade_tab[1]))
    assert carried.num_clusters == terrain["tr"].bvh.num_clusters


def test_t_bounds_and_corridor_keys_match_jax(terrain):
    jb, tb = terrain["jr"].bvh, terrain["jt"]
    jrays = terrain["jrays"]
    rays = _tray(jrays)
    boxes = (tb.sc_min, tb.sc_max)
    for t_max in (pc._INF, 0.125, 40.0):
        want = pc.ray_t_bounds(jb.cluster_min, jb.cluster_max, jrays, t_max)
        got = cluster.ray_t_bounds(tb.cluster_min, tb.cluster_max, rays, t_max, sc_boxes=boxes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        wk, wt = pc.corridor_keys_and_t_bounds(jb.cluster_min, jb.cluster_max, jrays, t_max)
        gk, gt = cluster.corridor_keys_and_t_bounds(tb.cluster_min, tb.cluster_max, rays, t_max, sc_boxes=boxes)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    # rays that overlap nothing: bound 0, key INT32_MAX
    up = Ray(origin=torch.full((16, 3), 1e4), direction=torch.tensor([[0.0, 1.0, 0.0]]).repeat(16, 1))
    k, t = cluster.corridor_keys_and_t_bounds(tb.cluster_min, tb.cluster_max, up, sc_boxes=boxes)
    assert (k == 0x7FFFFFFF).all() and (t == 0).all()


@pytest.fixture
def fresh_jax_caches():
    """JAX's compilation caches cleared before and after the test: the JAX
    traces are jitted, so only a fresh trace reads the module constants
    that a test patches, and no trace made with them outlives the test."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kind", ["tile", "lane"])
@pytest.mark.parametrize("level", ["single", "two_level", "sc_cap"])
def test_walk_matches_jax_in_every_cull_regime(terrain100, monkeypatch, fresh_jax_caches, kind, level):
    """The walk against the JAX package's list path with its cull forced
    into each regime: B3 against the tile-frustum cull's winners ("tile"),
    B4 against the per-lane cull's occlusion ("lane"), on every lane; with
    a supercluster cap of 2 the lists overflow and the JAX checked fallback
    runs, and the port, which lists nothing, still agrees."""
    jb, tb = terrain100[0].bvh, terrain100[2]
    n = 2048
    jrays = _random_rays(jb, n, seed=3, above=None)
    rays = _tray(jrays)
    t_max = np.full((n,), 1e5, np.float32)
    if level != "single":  # force the two-level path on this small fixture
        monkeypatch.setattr(pc, "_TWO_LEVEL_MIN_C", 1)
    if level == "sc_cap":  # a supercluster cap that binds: overflow through the SC level
        monkeypatch.setattr(pc, "_SC_CAND" if kind == "tile" else "_SC_CAND_LANE", 2)
    if kind == "tile":
        wkey, wcid, _, wstats = pc.trace_closest_clusters_packed(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays,
                                                                jnp.asarray(t_max), interpret=True)
        key, cid, _ = cluster.trace_closest_clusters_packed(tb, rays, torch.as_tensor(t_max))
        _assert_same_winners(key.numpy(), cid.numpy(), wkey, wcid)
        assert (np.asarray(wcid) >= 0).mean() > 0.2
    else:
        wocc, wstats = pc.trace_any_clusters(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays, jnp.asarray(t_max),
                                             refine=True, interpret=True)
        occ = cluster.trace_any_clusters(tb, rays, torch.as_tensor(t_max))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
        assert 0.1 < occ.float().mean() < 0.9
    capped = level == "sc_cap"
    assert (int(wstats["overflow"]) > 0) == capped and (int(wstats["retraced"]) > 0) == capped


def test_b3_plain_matches_jax_and_brute(terrain):
    jb, tb = terrain["jr"].bvh, terrain["jt"]
    jrays = terrain["jrays"]
    rays = _tray(jrays)
    key, cid, t_eff = cluster.trace_closest_clusters_packed(tb, rays)
    np.testing.assert_array_equal(t_eff.numpy(), terrain["t_eff"])
    _assert_same_winners(key.numpy(), cid.numpy(), terrain["key"], terrain["cid"])
    hit = cluster.decode_hits(key, cid, tb.tri_tab, rays, t_eff)
    want_ids, want_t = _brute_ids(jb, jrays)
    assert (hit.tri_id.numpy() == want_ids).mean() >= B3_AGREE_MIN
    m = want_ids >= 0
    assert m.mean() > 0.8
    np.testing.assert_allclose(hit.t.numpy()[m], want_t[m], **T_TOL)
    # the dispatcher's closest hit above 4096 triangles is this decode
    thit = ttraverse.trace_closest(tb, rays)
    for f in dataclasses.fields(hit):
        np.testing.assert_array_equal(getattr(thit, f.name).numpy(), getattr(hit, f.name).numpy(), err_msg=f.name)


def test_b3_b4_plain_per_lane_lists_match_jax(terrain100):
    """Incoherent rays against the JAX package's per-lane cull
    (refine=True): B3 against the JAX kernel and the oracle, B4 equal to
    the JAX kernel on every lane."""
    jb, tb = terrain100[0].bvh, terrain100[2]
    n = 2048
    jrays = _random_rays(jb, n, seed=11, above=1.1)
    rays = _tray(jrays)
    wkey, wcid, _, _ = pc.trace_closest_clusters_packed(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays,
                                                        refine=True, interpret=True)
    key, cid, t_eff = cluster.trace_closest_clusters_packed(tb, rays)
    _assert_same_winners(key.numpy(), cid.numpy(), wkey, wcid)
    want_ids, want_t = _brute_ids(jb, jrays)
    hit = cluster.decode_hits(key, cid, tb.tri_tab, rays, t_eff)
    assert (hit.tri_id.numpy() == want_ids).mean() >= B3_AGREE_MIN
    m = want_ids >= 0
    assert m.mean() > 0.2
    np.testing.assert_allclose(hit.t.numpy()[m], want_t[m], **T_TOL)

    t_max = np.full((n,), 1e5, np.float32)
    wocc, _ = pc.trace_any_clusters(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays, t_max=jnp.asarray(t_max),
                                    refine=True, interpret=True)
    occ = cluster.trace_any_clusters(tb, rays, torch.as_tensor(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    np.testing.assert_array_equal(occ.numpy(), want_ids >= 0)


def test_b4_plain_matches_jax_and_brute(terrain):
    jb, tb = terrain["jr"].bvh, terrain["tr"].bvh
    jrays = terrain["jrays"]
    n = jrays.origin.shape[0]
    # a t_max that cuts through the terrain: some hits lie beyond it
    t_max = np.random.default_rng(5).uniform(200.0, 1200.0, size=n).astype(np.float32)
    wocc, _ = pc.trace_any_clusters(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays, t_max=jnp.asarray(t_max),
                                    interpret=True)
    occ = cluster.trace_any_clusters(tb, _tray(jrays), torch.as_tensor(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    want_ids, want_t = _brute_ids(jb, jrays)
    want = (want_ids >= 0) & (want_t < t_max)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(occ.numpy(), want)


def test_overflow_fallback_matches_jax(terrain100):
    """The walk against the JAX package's list path with a list cap of 128
    on 310 clusters, scattered rays and a partial final tile: the JAX
    checked fallback runs, and the walk, which lists nothing, returns its
    hits, exact against brute force (JAX test_overflow_is_checked_not_silent)."""
    jb, tb = terrain100[0].bvh, terrain100[1].bvh
    n = 1000
    jrays = _random_rays(jb, n, seed=7, above=1.2)
    rays = _tray(jrays)
    whit, wstats = pc.trace_closest_clusters(jb.tri_tab, jb.geom_tab, jb.cluster_min, jb.cluster_max, jrays,
                                             max_visits=128, interpret=True)
    assert int(wstats["overflow"]) > 0 and int(wstats["unresolved_tiles"]) > 0
    key, cid, t_eff = cluster.trace_closest_clusters_packed(tb, rays)
    hit = cluster.decode_hits(key, cid, tb.tri_tab, rays, t_eff)
    want_ids, want_t = _brute_ids(jb, jrays)
    assert (hit.tri_id.numpy() == want_ids).mean() >= B3_AGREE_MIN
    assert (hit.tri_id.numpy() == np.asarray(whit.tri_id)).mean() >= B3_AGREE_MIN
    m = want_ids >= 0
    assert m.mean() > 0.2
    np.testing.assert_allclose(hit.t.numpy()[m], want_t[m], **T_TOL)

    t_max = np.full((n,), 1e5, np.float32)
    wocc, wastats = pc.trace_any_clusters(jb.tri_tab, jb.cluster_min, jb.cluster_max, jrays,
                                          t_max=jnp.asarray(t_max), max_visits=128, interpret=True)
    assert int(wastats["overflow"]) > 0
    occ = cluster.trace_any_clusters(tb, rays, torch.as_tensor(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    np.testing.assert_array_equal(occ.numpy(), want_ids >= 0)


def test_b5_plain_matches_jax(terrain):
    tb, jb = terrain["jt"], terrain["jr"].bvh
    key, cid = _t(terrain["key"]), _t(terrain["cid"])
    got = ct.fetch_winner_attrs_plain(tb.shade_a, tb.shade_b, key, cid)
    assert got.shape == (ct.N_SHADE_ATTR, key.shape[0])
    np.testing.assert_array_equal(got.numpy(), terrain["cols"])
    # and the JAX package's gather columns, on the hit lanes
    hit = terrain["cid"] >= 0
    rows = np.where(hit, terrain["cid"] * 64 + (terrain["key"] & 63), 0)
    want = np.concatenate([np.asarray(jb.shade_tab[0])[rows], np.asarray(jb.shade_tab[1])[rows, :6]], axis=1).T
    np.testing.assert_array_equal(got.numpy()[:, hit], want[:, hit])
    assert (got.numpy()[:, ~hit] == 0).all() and (~hit).sum() > 0


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """The committed gallery (5670 triangles, textures) at 64x64 with the
    port's primary trace on the JAX build's tables."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "gallery",
                        "scene.json")
    jr, tr, jt = _pair(path, 64, 64)
    jrays = _primaries(jr, 64, 64)
    key, cid, _ = cluster.trace_closest_clusters_packed(jt, _tray(jrays))
    return jr, tr, jt, jrays, key, cid


@pytest.mark.parametrize("scene", ["terrain", "gallery"])
def test_fused_shading_matches_jax(scene, terrain, gallery):
    """The same packed winners through both fused shading builds."""
    if scene == "terrain":
        jr, tr, jt, jrays, key, cid = terrain["jr"], terrain["tr"], terrain["jt"], terrain["jrays"], \
            _t(terrain["key"]), _t(terrain["cid"])
    else:
        jr, tr, jt, jrays, key, cid = gallery
        assert tr.device_scene.has_textures
    want = jshade.build_surface_interaction_fused(jr.device_scene, jrays, jnp.asarray(key.numpy()),
                                                  jnp.asarray(cid.numpy()), jr.bvh.shade_tab)
    got = tshade.shade_winners_plain(tr.device_scene, jt.shade_a, jt.shade_b, _tray(jrays), key, cid)
    assert np.asarray(want.hit).mean() > 0.8
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype, f.name
        np.testing.assert_allclose(g, w, err_msg=f.name, **SHADE_TOL)


def test_sorted_traces_match_unsorted(terrain100):
    """The corridor-sorted closest trace (bounce rays) gives the unsorted
    trace's winners, and the sorted occlusion trace the oracle's bits with
    dead lanes (t_max = 0) included."""
    jb, tr = terrain100[0].bvh, terrain100[1]
    n = 1000
    jrays = _random_rays(jb, n, seed=23, above=1.2)
    rays = _tray(jrays)
    ds, bvh = tr.device_scene, tr.bvh
    si_s = tshade.trace_closest_si(ds, bvh, rays, coherent=False)
    si_u = tshade.trace_closest_si(ds, bvh, rays, coherent=True)
    for f in dataclasses.fields(si_s):
        np.testing.assert_array_equal(getattr(si_s, f.name).numpy(), getattr(si_u, f.name).numpy(), err_msg=f.name)
    active = torch.arange(n) % 3 > 0
    si_a = tshade.trace_closest_si(ds, bvh, rays, active=active, coherent=False)
    assert not si_a.hit[~active].any()
    np.testing.assert_array_equal(si_a.p[active].numpy(), si_u.p[active].numpy())

    rng = np.random.default_rng(23)
    lo, hi = np.asarray(jb.cluster_min.min(axis=0)), np.asarray(jb.cluster_max.max(axis=0))
    t_max = (rng.random(n, np.float32) * float(np.linalg.norm(hi - lo))).astype(np.float32)
    t_max[::5] = 0.0
    occ = cluster.trace_any_clusters_sorted(bvh, rays, torch.as_tensor(t_max))
    want_ids, want_t = _brute_ids(jb, jrays)
    want = (want_ids >= 0) & (want_t < t_max)
    clear = np.abs(want_t - t_max) > 1e-3 * np.maximum(t_max, 1.0)
    assert want[clear].mean() > 0.1 and not occ.numpy()[t_max == 0].any()
    np.testing.assert_array_equal(occ.numpy()[clear], want[clear])


def test_cuda_wrappers_refuse_cpu_tensors(terrain):
    """A CUDA wrapper never runs the plain version: a CPU tensor is refused;
    and the routers refuse a device that is neither CUDA nor the CPU."""
    tb, ds = terrain["tr"].bvh, terrain["tr"].device_scene
    n = 64
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    key0, cid0 = torch.zeros(n, dtype=torch.int32), torch.full((n,), -1, dtype=torch.int32)
    walk = (tb.tri_tab, tb.cluster_min, tb.cluster_max, tb.sc_min, tb.sc_max)
    with pytest.raises(ValueError, match="CUDA"):
        shade_kernel.cluster_shade_cuda(ds, tb.shade_a, tb.shade_b, Ray(o, d), key0, cid0)
    with pytest.raises(ValueError, match="device"):
        tshade._cluster_shade(torch.device("meta"), False)
    with pytest.raises(ValueError, match="device"):
        ct.trace_closest_walk(*walk, o.to("meta"), d.to("meta"), key0, cid0)
    with pytest.raises(ValueError, match="device"):
        ct.trace_any_walk(*walk, o.to("meta"), d.to("meta"), torch.ones(n))
