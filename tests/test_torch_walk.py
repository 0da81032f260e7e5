"""The walk of kernels B3 and B4 (``accel.cluster_trace``: per ray, the
supercluster boxes, then the cluster boxes of those it passes, then the
triangles, with no lists) in its plain PyTorch version on the CPU, which
every CPU trace of the cluster tier takes.

Two scenes: a seeded grid-100 terrain (19,614 triangles, 307 clusters, 5
superclusters) and the committed gallery (5670 triangles, 89 clusters, 2
superclusters), each with 2048 incoherent rays from a numpy seed.  The JAX
side runs its Pallas kernels with ``interpret=True``, as
``tests/unit/test_pallas_cluster.py`` does, once per scene.

Tolerances:
* B3 against the JAX package's per-lane trace (``refine=True``), the port
  walking the JAX build's tables (``tests/torch_jax_tables.py``: the
  port's own build orders the clusters by a median split): the same
  winner (cluster id and local triangle id) on at least 99.9 % of lanes
  and equal keys on at least 99 % (XLA's CPU lowering contracts a*b + c*d
  into fused multiply-adds, the port rounds each operation; see
  tests/test_torch_cluster.py);
* B3 against brute force over the whole table: t to rtol 1e-5;
* B4 against the JAX package and brute force: every lane;
* the port's trace entry points on CPU rays against the plain walk called
  directly: bit for bit on every lane.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel import pallas_cluster as pc
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.accel import brute_trace, build, cluster, sweep_kernel, traverse
from optix_renderer_tpu_torch.accel import cluster_trace as ct
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene.config import parse_scene
from tests.torch_jax_tables import jax_tables

torch.set_num_threads(2)

N_RAYS = 2048
N_BRUTE = 384  # lanes held against brute force over the whole table
B3_AGREE_MIN = 0.999
B3_KEY_EQUAL_MIN = 0.99
SCENES = ["terrain", "gallery"]


def _walk_args(b):
    return b.tri_tab, b.cluster_min, b.cluster_max, b.sc_min, b.sc_max


def _t_up(key: torch.Tensor) -> torch.Tensor:
    return (key | 63).view(torch.float32)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Per scene: the two packages' tables, 2048 seeded rays with their t
    bounds, a seeded per-lane t_max with dead lanes, and the plain walk's
    winners."""
    paths = {
        "terrain": procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain100")), grid=100, width=32,
                                                  height=32),
        "gallery": os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "gallery",
                                "scene.json"),
    }
    out = {}
    for seed, (name, path) in enumerate(paths.items()):
        jb = JRenderer(jparse_scene(path), width=32, height=32, mode=RendererType.MASK).bvh
        tb = Renderer(parse_scene(path), width=32, height=32, mode=RendererType.MASK, device="cpu").bvh
        rng = np.random.default_rng(41 + seed)
        lo, hi = tb.cluster_min.amin(dim=0).numpy(), tb.cluster_max.amax(dim=0).numpy()
        o = (lo + rng.random((N_RAYS, 3), np.float32) * (hi - lo)).astype(np.float32)
        if name == "terrain":  # from above the heightfield
            o[:, 1] = hi[1] * 1.1
        d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_max = (rng.random(N_RAYS, np.float32) * float(np.linalg.norm(hi - lo))).astype(np.float32)
        t_max[::5] = 0.0
        rays = Ray(origin=torch.tensor(o), direction=torch.tensor(d))
        t_eff = cluster.ray_t_bounds(tb.cluster_min, tb.cluster_max, rays, 3.0e38, sc_boxes=(tb.sc_min, tb.sc_max))
        t_any = torch.minimum(t_eff, torch.tensor(t_max))
        key_w, cid_w = ct.trace_closest_walk_plain(*_walk_args(tb), rays.origin, rays.direction,
                                                   *cluster.cold_start_keys(t_eff))
        out[name] = dict(jb=jb, jt=jax_tables(jb), tb=tb, rays=rays,
                         jrays=JRay(origin=jnp.asarray(o), direction=jnp.asarray(d)),
                         t_eff=t_eff, t_max=t_max, t_any=t_any, key_w=key_w, cid_w=cid_w)
    return out


def test_supercluster_boxes_cover_their_clusters(scenes):
    for s in scenes.values():
        b = s["tb"]
        S = -(-b.num_clusters // build.SC_GROUP)
        assert b.sc_min.shape == (S, 3) and b.sc_max.shape == (S, 3) and S >= 2
        _, _, _, _, sc_min, sc_max = cluster._superclusters(b.cluster_min, b.cluster_max)
        np.testing.assert_array_equal(b.sc_min.numpy(), sc_min.numpy())
        np.testing.assert_array_equal(b.sc_max.numpy(), sc_max.numpy())
        owner = torch.arange(b.num_clusters) // build.SC_GROUP
        assert (b.sc_min[owner] <= b.cluster_min).all() and (b.sc_max[owner] >= b.cluster_max).all()


@pytest.mark.parametrize("scene", SCENES)
def test_walk_closest_matches_jax(scenes, scene):
    s = scenes[scene]
    jb, jt, rays = s["jb"], s["jt"], s["rays"]
    wkey, wcid, _, _ = pc.trace_closest_clusters_packed(jb.tri_tab, jb.cluster_min, jb.cluster_max, s["jrays"],
                                                        refine=True, interpret=True)
    t_eff = cluster.ray_t_bounds(jt.cluster_min, jt.cluster_max, rays, 3.0e38, sc_boxes=(jt.sc_min, jt.sc_max))
    key, cid = ct.trace_closest_walk_plain(*_walk_args(jt), rays.origin, rays.direction,
                                           *cluster.cold_start_keys(t_eff))
    key, cid, wkey, wcid = key.numpy(), cid.numpy(), np.asarray(wkey), np.asarray(wcid)
    assert (wcid >= 0).mean() > 0.2
    winner = (cid == wcid) & ((key & 63) == (wkey & 63)) & (np.abs((key >> 6) - (wkey >> 6)) <= 1)
    assert winner.mean() >= B3_AGREE_MIN, winner.mean()
    assert ((key == wkey) & (cid == wcid)).mean() >= B3_KEY_EQUAL_MIN


@pytest.mark.parametrize("scene", SCENES)
def test_cpu_entry_points_take_the_plain_walk(scenes, scene):
    """On CPU rays the port's trace entry points are the plain walk: the
    dispatcher's packed winners in the given order (``coherent=True``),
    corridor-sorted and unsorted (``coherent=False``) and with an ``active``
    mask, and its occlusion both ways, equal the plain walk called directly
    on every lane, and no kernel launch is counted."""
    s = scenes[scene]
    tb, rays = s["tb"], s["rays"]
    ct.reset_launch_counts()
    sweep_kernel.reset_launch_counts()
    for coherent in (True, False):
        key, cid, t_b, _ = traverse.trace_closest_winners(tb, rays, coherent=coherent)
        np.testing.assert_array_equal(t_b.numpy(), s["t_eff"].numpy())
        np.testing.assert_array_equal(key.numpy(), s["key_w"].numpy())
        np.testing.assert_array_equal(cid.numpy(), s["cid_w"].numpy())
        occ = traverse.trace_any(tb, rays, t_max=torch.as_tensor(s["t_max"]), coherent=coherent)
        want = ct.trace_any_walk_plain(*_walk_args(tb), rays.origin, rays.direction, s["t_any"])
        np.testing.assert_array_equal(occ.numpy(), want.numpy())
    active = torch.tensor(s["t_max"] > 0.0)
    key, cid, _t, _ = traverse.trace_closest_winners(tb, rays, active=active, coherent=False)
    np.testing.assert_array_equal(key[active].numpy(), s["key_w"][active].numpy())
    np.testing.assert_array_equal(cid[active].numpy(), s["cid_w"][active].numpy())
    assert (cid[~active] == -1).all() and (~active).sum() > 100
    assert not any(ct.LAUNCHES.values()) and not any(sweep_kernel.LAUNCHES.values())


@pytest.mark.parametrize("scene", SCENES)
def test_walk_closest_matches_brute_force(scenes, scene):
    s = scenes[scene]
    tb, rays = s["tb"], s["rays"]
    sub = Ray(origin=rays.origin[:N_BRUTE], direction=rays.direction[:N_BRUTE])
    t_b, id_b, _, _ = brute_trace.trace_closest_plain(tb.tri_tab, sub.origin, sub.direction,
                                                      torch.full((N_BRUTE,), 3.0e38))
    hit = cluster.decode_hits(s["key_w"][:N_BRUTE], s["cid_w"][:N_BRUTE], tb.tri_tab, sub, s["t_eff"][:N_BRUTE])
    m = id_b >= 0
    assert 0.2 < m.float().mean() and ((hit.tri_id >= 0) == m).all()
    np.testing.assert_allclose(hit.t[m].numpy(), t_b[m].numpy(), rtol=1e-5)
    assert (hit.tri_id == id_b).float().mean() >= B3_AGREE_MIN


@pytest.mark.parametrize("scene", SCENES)
def test_walk_any_matches_jax_list_path_and_brute_force(scenes, scene):
    """B4's plain walk against the JAX package's per-lane list path and
    brute force."""
    s = scenes[scene]
    jb, tb, rays = s["jb"], s["tb"], s["rays"]
    occ = ct.trace_any_walk_plain(*_walk_args(tb), rays.origin, rays.direction, s["t_any"])
    wocc, _ = pc.trace_any_clusters(jb.tri_tab, jb.cluster_min, jb.cluster_max, s["jrays"],
                                    t_max=jnp.asarray(s["t_max"]), refine=True, interpret=True)
    assert 0.05 < occ.float().mean() < 0.9
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    want = brute_trace.trace_any_plain(tb.tri_tab, rays.origin[:N_BRUTE], rays.direction[:N_BRUTE],
                                       s["t_any"][:N_BRUTE])
    np.testing.assert_array_equal(occ[:N_BRUTE].numpy(), want.numpy())


@pytest.mark.parametrize("scene", SCENES)
def test_walk_dead_lanes_stay_misses(scenes, scene):
    """Lanes with t_max = 0 and above-scene up-rays (what the integrators
    make of inactive lanes) hit nothing in either form."""
    s = scenes[scene]
    tb, rays = s["tb"], s["rays"]
    dead = torch.tensor(s["t_max"] == 0.0)
    assert dead.sum() > 100
    occ = ct.trace_any_walk_plain(*_walk_args(tb), rays.origin, rays.direction, s["t_any"])
    assert not occ[dead].any()
    up = cluster.rays_above_scene(tb, rays, ~dead)
    t_eff = cluster.ray_t_bounds(tb.cluster_min, tb.cluster_max, up, 3.0e38, sc_boxes=(tb.sc_min, tb.sc_max))
    assert (t_eff[dead] == 0).all()
    key0, cid0 = cluster.cold_start_keys(t_eff)
    key, cid = ct.trace_closest_walk_plain(*_walk_args(tb), up.origin, up.direction, key0, cid0)
    assert (cid[dead] == -1).all() and (key[dead] == key0[dead]).all()
    live = ~dead
    np.testing.assert_array_equal(key[live].numpy(), s["key_w"][live].numpy())
    assert not ct.trace_any_walk_plain(*_walk_args(tb), up.origin, up.direction, t_eff)[dead].any()


@pytest.mark.parametrize("scene", SCENES)
def test_walk_warm_start_never_worsens_a_key(scenes, scene):
    s = scenes[scene]
    tb, rays = s["tb"], s["rays"]
    cold_key, cold_cid = cluster.cold_start_keys(s["t_eff"])
    # from the answer itself: nothing beats it, so key and cluster id stay
    key, cid = ct.trace_closest_walk_plain(*_walk_args(tb), rays.origin, rays.direction, s["key_w"], s["cid_w"])
    np.testing.assert_array_equal(key.numpy(), s["key_w"].numpy())
    np.testing.assert_array_equal(cid.numpy(), s["cid_w"].numpy())
    # from a mix of answers, cold starts and keys that are too good to beat
    lane = torch.arange(N_RAYS)
    key0 = torch.where(lane % 3 == 0, s["key_w"], cold_key)
    cid0 = torch.where(lane % 3 == 0, s["cid_w"], cold_cid)
    key0 = torch.where(lane % 3 == 1, torch.minimum(s["key_w"], torch.tensor(0x3F800000)) - 64, key0)  # below t = 1
    cid0 = torch.where(lane % 3 == 1, 0, cid0)
    key, cid = ct.trace_closest_walk_plain(*_walk_args(tb), rays.origin, rays.direction, key0, cid0)
    assert (key <= key0).all()
    np.testing.assert_array_equal(key.numpy(), torch.minimum(key0, s["key_w"]).numpy())
    kept = key == key0
    assert (cid[kept] == cid0[kept]).all() and (lane[~kept] % 3 == 2).all()


def test_walk_bound_counts(scenes):
    """The least work of a walk: every supercluster box for every lane, the
    cluster boxes of each supercluster and 64 triangles per cluster that
    pass within the lane's final bound; an occluded lane counts one of each,
    a lane whose bound is not above 0 nothing."""
    s = scenes["terrain"]
    tb, rays = s["tb"], s["rays"]
    S = tb.sc_min.shape[0]
    boxes = _walk_args(tb)[1:]
    slabs, tests = ct.walk_bound_counts(*boxes, rays.origin, rays.direction, _t_up(s["key_w"]))
    slabs0, tests0 = ct.walk_bound_counts(*boxes, rays.origin, rays.direction, s["t_eff"])
    hits = int((s["cid_w"] >= 0).sum())
    assert N_RAYS * S < slabs <= slabs0 and 64 * hits <= tests <= tests0 and tests % 64 == 0
    zero = torch.zeros(N_RAYS)
    assert ct.walk_bound_counts(*boxes, rays.origin, rays.direction, zero) == (0, 0)
    all_occ = torch.ones(N_RAYS, dtype=torch.bool)
    live = int((s["t_any"] > 0).sum())
    assert 0 < live < N_RAYS
    assert ct.walk_bound_counts(*boxes, rays.origin, rays.direction, s["t_any"], occluded=all_occ) == (
        live * (S + 64), live * 64)
    # the last supercluster holds fewer than 64 clusters: a far bound counts every cluster box once
    far = torch.full((N_RAYS,), 3.0e38)
    slabs_far, _ = ct.walk_bound_counts(*boxes, rays.origin, rays.direction, far)
    assert tb.num_clusters % 64 != 0 and slabs_far <= N_RAYS * (S + tb.num_clusters)


def test_per_lane_traces_on_the_cpu_take_the_plain_walk(scenes):
    """The rays' device decides: CPU tensors never reach a kernel, and the
    cluster tier's traces return the plain walk's answers."""
    s = scenes["gallery"]
    tb, rays = s["tb"], s["rays"]
    assert not cluster._k_sweep(rays)
    ct.reset_launch_counts()
    key, cid, _ = cluster.trace_closest_clusters_packed(tb, rays, t_eff=s["t_eff"])
    occ = cluster.trace_any_clusters(tb, rays, t_eff=s["t_any"])
    assert not any(ct.LAUNCHES.values())
    np.testing.assert_array_equal(key.numpy(), s["key_w"].numpy())
    np.testing.assert_array_equal(cid.numpy(), s["cid_w"].numpy())
    want = ct.trace_any_walk_plain(*_walk_args(tb), rays.origin, rays.direction, s["t_any"])
    np.testing.assert_array_equal(occ.numpy(), want.numpy())


def test_walk_cuda_wrappers_refuse_cpu_tensors(scenes):
    """A CUDA wrapper never runs the plain version: a CPU tensor is refused,
    and so is a malformed input."""
    s = scenes["gallery"]
    tb, rays = s["tb"], s["rays"]
    key0, cid0 = cluster.cold_start_keys(s["t_eff"])
    args = (*_walk_args(tb), rays.origin, rays.direction)
    with pytest.raises(ValueError, match="CUDA"):
        ct.trace_closest_walk_cuda(*args, key0, cid0)
    with pytest.raises(ValueError, match="CUDA"):
        ct.trace_any_walk_cuda(*args, s["t_any"])
    with pytest.raises(ValueError, match="supercluster boxes"):
        ct.trace_any_walk_cuda(*args[:3], tb.sc_min[:1], tb.sc_max[:1], *args[5:], s["t_any"])
    with pytest.raises(ValueError, match=r"origin must be \(N, 3\)"):
        ct.trace_closest_walk_cuda(*args[:5], rays.origin[:, :2], rays.direction, key0, cid0)
