"""The shared-origin baked primary trace (B3-baked) of the port on the CPU:
``accel.cluster.bake_shared_origin_tab``, the plain baked walk
(``cluster_trace.trace_closest_walk_plain(..., baked=True)``), its routing
and the Renderer's per-camera bake.  Mirrors ``tests/unit/test_baked_mt.py``
on the grid-60 terrain (7,212 triangles, cluster tier) at 64^2, with the
JAX camera's primary rays fed to both packages as numpy.

Tolerances:
* the bake of the JAX build's table (``tests/torch_jax_tables.py``: the
  port's own build orders the clusters by a median split) against the
  JAX bake: columns 0-9 to rtol 1e-5, atol 1e-6 (XLA's
  CPU lowering may contract the cross products into fused multiply-adds,
  the port rounds each operation); columns 10-14 equal the unbaked table;
* the plain baked walk against the JAX baked kernel (interpret mode), JAX
  brute force and the port's unbaked walk: the same triangle on at least
  99.9 % of lanes (reassociated products may flip a tie within an ulp),
  and t to rtol 1e-4, atol 1e-3 after ``decode_hits`` on the unbaked
  table (test_baked_mt.py's tolerances);
* a forced-bake NORMALS render against the unforced CPU render: relative
  RMSE 1e-4 (the goldens' tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel import pallas_cluster as pc
from optix_renderer_tpu.accel.traverse import intersect_brute
from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.accel import build, cluster, traverse
from optix_renderer_tpu_torch.accel import cluster_trace as ct
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine import renderer as renderer_mod
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.engine.shade import trace_closest_si
from optix_renderer_tpu_torch.scene.config import SceneCamera, parse_scene
from tests.torch_jax_tables import jax_tables

torch.set_num_threads(2)

RES = 64
AGREE_MIN = 0.999
T_RTOL, T_ATOL = 1e-4, 1e-3
RMSE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The grid-60 terrain in both packages, the JAX camera's 64^2 primary
    rays (one shared origin) as numpy, and both bakes of that origin."""
    path = procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain_baked")), grid=60, width=RES,
                                          height=RES)
    jr = JRenderer(jparse_scene(path), width=RES, height=RES, mode=RendererType.MASK)
    lin = jnp.arange(RES * RES, dtype=jnp.uint32)
    rstate = jrng.make_rng(10007, lin)
    rstate, ju = jrng.lcg_randomf(rstate)
    rstate, jv = jrng.lcg_randomf(rstate)
    jrays = jcamera.primary_rays(jr.state.camera, RES, RES, ju, jv, lin=lin)
    o, d = np.array(jrays.origin), np.array(jrays.direction)  # writable copies for torch.from_numpy
    assert (o == o[0]).all()  # one shared origin
    tb = Renderer(parse_scene(path), width=RES, height=RES, mode=RendererType.MASK, device="cpu").bvh
    assert tb.clustered
    return {"path": path, "jbvh": jr.bvh, "jrays": jrays, "bvh": tb, "o": o, "d": d,
            "rays": Ray(origin=torch.from_numpy(o), direction=torch.from_numpy(d)),
            "jbaked": pc.bake_shared_origin_tab(jr.bvh.tri_tab, jrays.origin[0]),
            "baked": cluster.bake_shared_origin_tab(tb.tri_tab, o[0])}


def _walk_args(b):
    return b.cluster_min, b.cluster_max, b.sc_min, b.sc_max


def _baked_hit(s):
    """The plain baked walk's winners, decoded on the unbaked table."""
    b, rays = s["bvh"], s["rays"]
    t_eff = cluster.ray_t_bounds(b.cluster_min, b.cluster_max, rays, 3.0e38, sc_boxes=(b.sc_min, b.sc_max))
    key, cid = ct.trace_closest_walk_plain(s["baked"].tab, *_walk_args(b), rays.origin, rays.direction,
                                           *cluster.cold_start_keys(t_eff), baked=True)
    return cluster.decode_hits(key, cid, b.tri_tab, rays, t_eff), (key, cid, t_eff)


def test_bake_matches_jax_bake(setup):
    s = setup
    jt = jax_tables(s["jbvh"])
    flat_unbaked = build.flat_from_grouped(np.asarray(s["jbvh"].tri_tab))
    np.testing.assert_array_equal(flat_unbaked[:, :15], jt.tri_tab.numpy()[:, :15])  # the same table
    baked = cluster.bake_shared_origin_tab(jt.tri_tab, s["o"][0])
    want = build.flat_from_grouped(np.asarray(s["jbaked"]))
    got = baked.tab.numpy()
    assert got.shape == s["bvh"].tri_tab.shape == jt.tri_tab.shape
    assert np.array_equal(baked.origin, s["o"][0]) and np.array_equal(s["baked"].origin, s["o"][0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 10:15], jt.tri_tab.numpy()[:, 10:15])
    pad = (jt.tri_tab.numpy()[:, 3:9] == 0.0).all(axis=1)  # e1 = e2 = 0
    assert pad.any() and (got[pad, 0:3] == 0.0).all()  # n2 = 0: det = 0, a miss


def test_plain_baked_walk_matches_jax_and_brute_force(setup):
    s = setup
    hit, _ = _baked_hit(s)
    ids, t = hit.tri_id.numpy(), hit.t.numpy()
    jb = s["jbvh"]
    ch_b, _ = pc.trace_closest_clusters(jb.tri_tab, jb.geom_tab, jb.cluster_min, jb.cluster_max, s["jrays"],
                                        interpret=True, baked_tab=s["jbaked"])
    ids_j, t_j = np.asarray(ch_b.tri_id), np.asarray(ch_b.t)
    assert (ids == ids_j).mean() >= AGREE_MIN
    m = (ids >= 0) & (ids_j >= 0)
    np.testing.assert_allclose(t[m], t_j[m], rtol=T_RTOL, atol=T_ATOL)

    tris = jnp.stack([jb.tri_v0, jb.tri_v0 + jb.tri_e1, jb.tri_v0 + jb.tri_e2], axis=1)
    want = intersect_brute(tris, JRay(origin=jnp.asarray(s["o"]), direction=jnp.asarray(s["d"])))
    wid = np.asarray(want.tri_id)
    want_ids = np.where(wid >= 0, np.asarray(jb.prim_id)[np.maximum(wid, 0)], -1)
    assert (ids == want_ids).mean() >= AGREE_MIN
    mo = want_ids >= 0
    assert mo.mean() > 0.8
    np.testing.assert_allclose(t[mo], np.asarray(want.t)[mo], rtol=T_RTOL, atol=T_ATOL)


def test_plain_baked_walk_matches_unbaked_walk(setup):
    s = setup
    b, rays = s["bvh"], s["rays"]
    hit, (key, cid, t_eff) = _baked_hit(s)
    key_u, cid_u = ct.trace_closest_walk_plain(b.tri_tab, *_walk_args(b), rays.origin, rays.direction,
                                               *cluster.cold_start_keys(t_eff))
    assert (cid_u >= 0).float().mean().item() > 0.8
    rows, _ = ct.winner_rows(key, cid)
    rows_u, _ = ct.winner_rows(key_u, cid_u)
    same = (torch.where(cid >= 0, rows, -1) == torch.where(cid_u >= 0, rows_u, -1)).float().mean().item()
    assert same >= AGREE_MIN
    # and the port's routing takes the plain baked walk for CPU rays with a baked table
    key_r, cid_r, _t, _ = traverse.trace_closest_winners(b, rays, baked_tab=s["baked"])
    assert torch.equal(key_r, key) and torch.equal(cid_r, cid)


@pytest.mark.parametrize("case", ["active", "incoherent", "decode"])
def test_routing_refuses_a_baked_table_where_the_origin_is_not_shared(setup, case):
    s = setup
    b, rays, baked = s["bvh"], s["rays"], s["baked"]
    with pytest.raises(ValueError, match="baked"):
        if case == "active":
            trace_closest_si(None, b, rays, active=torch.ones(rays.origin.shape[0], dtype=torch.bool),
                             baked_tab=baked)
        elif case == "incoherent":
            traverse.trace_closest_winners(b, rays, coherent=False, baked_tab=baked)
        else:
            _hit, (key, cid, t_eff) = _baked_hit(s)
            cluster.decode_hits(key, cid, baked, rays, t_eff)


@pytest.fixture
def forced(monkeypatch):
    """Renderers built while this fixture is active bake on the CPU too."""
    monkeypatch.setattr(renderer_mod, "_bakes", lambda bvh: bvh.clustered)


def _moved(cam: SceneCamera) -> SceneCamera:
    return SceneCamera(from_=np.asarray(cam.from_, np.float32) + np.float32([3.0, -2.0, 5.0]), at=cam.at,
                       up=cam.up, cos_fovy=cam.cos_fovy)


def test_renderer_rebakes_on_set_camera(setup, forced):
    s = setup
    r = Renderer(parse_scene(s["path"]), width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    cam0 = r.scene.cameras[0]
    first = r.baked_tab
    assert first is not None and np.array_equal(first.origin, np.asarray(cam0.from_, np.float32))
    r.set_camera(cam0)
    assert r.baked_tab is first  # the origin did not move: nothing is baked again
    cam1 = _moved(cam0)
    r.set_camera(cam1)
    assert np.array_equal(r.baked_tab.origin, np.asarray(cam1.from_, np.float32))
    assert torch.equal(r.baked_tab.tab, cluster.bake_shared_origin_tab(r.bvh.tri_tab, cam1.from_).tab)


def test_renderer_rebakes_on_load_checkpoint(setup, forced, tmp_path):
    s = setup
    scene = parse_scene(s["path"])
    a = Renderer(scene, width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    cam1 = _moved(scene.cameras[0])
    a.set_camera(cam1)
    a.render(1)
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    b = Renderer(scene, width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    assert not np.array_equal(b.baked_tab.origin, a.baked_tab.origin)
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    assert np.array_equal(b.baked_tab.origin, np.asarray(cam1.from_, np.float32))
    assert torch.equal(b.baked_tab.tab, a.baked_tab.tab)


def test_renderer_keeps_the_table_across_set_mode(setup, forced):
    r = Renderer(parse_scene(setup["path"]), width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    first = r.baked_tab
    r.set_mode(RendererType.MASK)
    assert r.baked_tab is first


def test_forced_bake_render_matches_the_cpu_render(setup, monkeypatch):
    scene = parse_scene(setup["path"])
    plain = Renderer(scene, width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    plain.render(1)
    monkeypatch.setattr(renderer_mod, "_bakes", lambda bvh: bvh.clustered)
    baked = Renderer(scene, width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    assert baked.baked_tab is not None
    baked.render(1)
    want, got = plain.image(), baked.image()
    rmse = float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)
    assert rmse < RMSE_TOL, rmse


def test_cpu_renderer_does_not_bake(setup):
    r = Renderer(parse_scene(setup["path"]), width=RES, height=RES, mode=RendererType.NORMALS, device="cpu")
    assert r.baked_tab is None
    r.set_camera(_moved(r.scene.cameras[0]))
    assert r.baked_tab is None
