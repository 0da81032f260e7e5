"""Kernel K-sweep, the cluster tier's per-ray supercluster sweep
(``accel.sweep_kernel``, routed by ``accel.cluster.ray_t_bounds`` and
``corridor_keys_and_t_bounds``).

On the CPU: the wrapper refuses CPU tensors, wrong dtypes and wrong shapes
without building or loading its library; a CPU cluster-tier trace neither
loads it nor counts a launch; the BVH's supercluster boxes equal
``cluster._superclusters``' (which the plain sweep takes) on a terrain whose
cluster count is no multiple of 64; and the routing, with a stand-in for the
kernel, hands it the plain sweep's boxes, bit width and t_max.

On a CUDA card (skipped without one): the kernel's t bound and corridor key
bit-equal to the plain sweep run on the card, through both entry points, on
the 1M-triangle terrain's 1024^2 primaries and 1M bounce-like rays
(``utils.bench_rays``), above-scene up-rays, origins inside several boxes
(ties at near = 0), directions with components under 1e-20, scalar, 0-d and
(N,) t_max with +0, -0, negatives and NaN (a +0 t_max skips the boxes),
the gallery (at most 512 clusters: the
boxes are the clusters), synthetic cluster boxes with S = 625, 1,094 and
32,770 superclusters (three key widths; more boxes than a block stages at a
time), N = 1 and N = 1,000; one launch a call; a gallery frame and a frame
of SPD's tetra (its sweeps over the superclusters) through the kernel
bit-equal to one through the plain sweep; one launch a cluster-tier trace
through a replayed frame graph.  This file imports no JAX, so it runs on
the card as ``python -m pytest --noconftest tests/test_torch_sweep_kernel.py``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from optix_renderer_tpu_torch.accel import cluster
from optix_renderer_tpu_torch.accel import sweep_kernel as sk
from optix_renderer_tpu_torch.accel.traverse import trace_any, trace_closest
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.scene import parse_scene, write_terrain_scene
from optix_renderer_tpu_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "gallery", "scene.json")
# SPD's tetra at 1,048,576 triangles: 16,384 clusters, 256 superclusters
TETRA = os.path.join(ROOT, "portbench", "scenes", "spd-tetra", "scene.json")
# 2 * 129^2 + 12 = 33,294 triangles: 521 clusters (9 past a multiple of 64), 9 superclusters
TERRAIN_GRID = 130


def _no_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("built or loaded the sweep kernel's library")

    monkeypatch.setattr(sk, "kernel_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "build_library", refuse)


def _scene_bvh(path: str, device):
    return Renderer(parse_scene(path), width=16, height=16, mode=RendererType.MASK, device=device).bvh


@pytest.fixture(scope="module")
def terrain_cpu(tmp_path_factory):
    return _scene_bvh(write_terrain_scene(str(tmp_path_factory.mktemp("terrain")), grid=TERRAIN_GRID, width=16,
                                          height=16), "cpu")


def _seeded_rays(bvh, n: int, seed: int, device="cpu") -> Ray:
    """Origins in the scene's box (a third above its top), unit directions."""
    rng = np.random.default_rng(seed)
    lo, hi = bvh.cluster_min.amin(dim=0).cpu().numpy(), bvh.cluster_max.amax(dim=0).cpu().numpy()
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    o[: n // 3, 1] = hi[1] * 1.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(origin=torch.tensor(o, device=device), direction=torch.tensor(d, device=device))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _args(n=8, s=4, dtype=torch.float32, device="cpu"):
    return (torch.zeros((s, 3), dtype=dtype, device=device), torch.ones((s, 3), dtype=dtype, device=device),
            torch.zeros((n, 3), dtype=dtype, device=device), torch.ones((n, 3), dtype=dtype, device=device))


@pytest.mark.parametrize("case", ["cpu tensors", "float64 rays", "float64 boxes", "rays (n, 4)", "boxes (s,)",
                                  "directions of another count", "no boxes", "t_max (n + 1,)", "t_max float64",
                                  "key bits too few"])
def test_the_wrapper_refuses_without_building(case, monkeypatch):
    _no_library(monkeypatch)
    bmin, bmax, o, d = _args()
    t_max, key_bits, match = 3.0e38, None, "rays on a CUDA device"
    if case == "float64 rays":
        o, match = o.double(), "origin must be a float32"
    elif case == "float64 boxes":
        bmax, match = bmax.double(), "box_max must be a float32"
    elif case == "rays (n, 4)":
        o, d, match = torch.zeros((8, 4)), torch.zeros((8, 4)), r"origin must be a float32 \(8, 3\)"
    elif case == "boxes (s,)":
        bmin, match = torch.zeros(4), "box_min must be a float32"
    elif case == "directions of another count":
        d, match = torch.ones((7, 3)), r"direction must be a float32 \(8, 3\)"
    elif case == "no boxes":
        bmin, bmax, match = torch.zeros((0, 3)), torch.zeros((0, 3)), "over 0 boxes"
    elif case == "t_max (n + 1,)":
        t_max, match = torch.zeros(9), "t_max must be float32"
    elif case == "t_max float64":
        t_max, match = torch.zeros(8, dtype=torch.float64), "t_max must be float32"
    elif case == "key bits too few":
        key_bits, match = 1, "cannot hold 4 boxes"
    with pytest.raises(ValueError, match=match):
        sk.sc_sweep_cuda(bmin, bmax, o, d, t_max, key_bits)
    assert not torch.cuda.is_initialized()


def test_a_cpu_cluster_trace_never_loads_the_sweep_kernel(terrain_cpu, monkeypatch):
    _no_library(monkeypatch)
    sk.reset_launch_counts()
    b = terrain_cpu
    assert b.clustered and b.num_clusters > 512
    rays = _seeded_rays(b, 512, 3)
    t_plain = cluster.ray_t_bounds_plain(b.cluster_min, b.cluster_max, rays, 3.0e38)
    assert torch.equal(cluster.ray_t_bounds(b.cluster_min, b.cluster_max, rays, 3.0e38,
                                            sc_boxes=(b.sc_min, b.sc_max)), t_plain)
    hit = trace_closest(b, rays, coherent=False)
    occ = trace_any(b, rays, t_max=torch.full((512,), 50.0), coherent=False)
    assert bool((hit.tri_id >= 0).any()) and bool(occ.any())
    assert sk.LAUNCHES == {"sc_sweep": 0}
    assert not torch.cuda.is_initialized()


def test_the_bvh_supercluster_boxes_equal_the_plain_sweeps(terrain_cpu):
    b = terrain_cpu
    C = b.num_clusters
    assert C % 64 != 0 and C > 512
    S, _G, _cmin, _cmax, sc_min, sc_max = cluster._superclusters(b.cluster_min, b.cluster_max)
    assert S == -(-C // 64) == b.sc_min.shape[0]
    assert torch.equal(b.sc_min, sc_min) and torch.equal(b.sc_max, sc_max)


@pytest.fixture(scope="module")
def gallery_cpu():
    return _scene_bvh(GALLERY, "cpu")


@pytest.mark.parametrize("scene", ["terrain", "gallery"])
@pytest.mark.parametrize("t_kind", ["scalar", "0-d", "(N,)"])
def test_the_routing_hands_the_kernel_the_plain_sweeps_inputs(scene, t_kind, terrain_cpu, gallery_cpu, monkeypatch):
    """With CUDA rays stood in by CPU rays and the kernel by the plain sweep
    over the boxes it is handed (at most 512 boxes, which the plain sweep
    takes as they are), both entry points return the plain sweep's bits."""
    b = terrain_cpu if scene == "terrain" else gallery_cpu
    rays = _seeded_rays(b, 700, 11)
    rng = np.random.default_rng(5)
    t_max = {"scalar": 40.0, "0-d": torch.tensor(40.0, dtype=torch.float64),
             "(N,)": torch.tensor(np.where(rng.random(700) < 0.3, 0.0, rng.random(700) * 80.0), dtype=torch.float32)
             }[t_kind]
    calls = []

    def stand_in(bmin, bmax, o, d, t, key_bits):
        calls.append((bmin.shape[0], key_bits, t))
        assert bmin.shape[0] <= 512 and bmin.is_contiguous() and o.is_contiguous()
        r = Ray(origin=o, direction=d)
        if key_bits is None:
            return cluster.ray_t_bounds_plain(bmin, bmax, r, t), None
        key, t_eff = cluster.corridor_keys_and_t_bounds_plain(bmin, bmax, r, t)
        return t_eff, key

    monkeypatch.setattr(cluster, "_k_sweep", lambda rays: True)
    monkeypatch.setattr(sk, "sc_sweep_cuda", stand_in)
    boxes = (b.sc_min, b.sc_max)
    got_t = cluster.ray_t_bounds(b.cluster_min, b.cluster_max, rays, t_max, sc_boxes=boxes)
    got_k, got_t2 = cluster.corridor_keys_and_t_bounds(b.cluster_min, b.cluster_max, rays, t_max, sc_boxes=boxes)
    want_t = cluster.ray_t_bounds_plain(b.cluster_min, b.cluster_max, rays, t_max)
    want_k, want_t2 = cluster.corridor_keys_and_t_bounds_plain(b.cluster_min, b.cluster_max, rays, t_max)
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got_t2.view(torch.int32), want_t2.view(torch.int32)) and torch.equal(got_k, want_k)
    S = b.sc_min.shape[0] if b.num_clusters > 512 else b.num_clusters
    assert [(s, k) for s, k, _t in calls] == [(S, None), (S, cluster._cid_bits(S))]
    for _s, _k, t in calls:
        assert not isinstance(t, torch.Tensor) or t.dtype == torch.float32
    assert bool((want_t > 0).any()) and bool((want_k != 0x7FFFFFFF).any())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("K-sweep is a CUDA kernel: it runs only on a CUDA card")
    return torch.device("cuda", 0)


def _bits_equal(got, want, label):
    assert got.shape == want.shape and got.dtype == want.dtype, f"{label}: {got.dtype} {tuple(got.shape)}"
    g = got.view(torch.int32) if got.dtype == torch.float32 else got
    w = want.view(torch.int32) if want.dtype == torch.float32 else want
    bad = (g != w).nonzero().flatten()
    assert bad.numel() == 0, (f"{label}: {bad.numel()} lanes differ, first {bad[:4].tolist()}: kernel "
                              f"{got[bad[:4]].tolist()}, plain {want[bad[:4]].tolist()}")


def _check_sweep(cmin, cmax, rays: Ray, t_max, label, sc_boxes):
    """Both entry points on the card against the plain sweep there, bit for
    bit, one launch each; returns the plain (t bound, key)."""
    sk.reset_launch_counts()
    got_t = cluster.ray_t_bounds(cmin, cmax, rays, t_max, sc_boxes=sc_boxes)
    got_k, got_t2 = cluster.corridor_keys_and_t_bounds(cmin, cmax, rays, t_max, sc_boxes=sc_boxes)
    assert sk.LAUNCHES["sc_sweep"] == 2, f"{label}: {sk.LAUNCHES}"
    want_t = cluster.ray_t_bounds_plain(cmin, cmax, rays, t_max)
    want_k, want_t2 = cluster.corridor_keys_and_t_bounds_plain(cmin, cmax, rays, t_max)
    _bits_equal(got_t, want_t, f"{label}: t bound")
    _bits_equal(got_t2, want_t2, f"{label}: the key's t bound")
    _bits_equal(got_k, want_k, f"{label}: key")
    return want_t, want_k


@pytest.fixture(scope="module")
def terrain_1m(tmp_path_factory):
    dev = _card()
    path = write_terrain_scene(str(tmp_path_factory.mktemp("terrain1m")), grid=708, width=1024, height=1024)
    return Renderer(parse_scene(path), width=1024, height=1024, mode=RendererType.NORMALS, device=dev)


def test_k_sweep_on_the_1m_terrains_primaries_and_bounce_rays(terrain_1m):
    from optix_renderer_tpu_torch.engine.camera_kernel import pixel_order
    from optix_renderer_tpu_torch.utils.bench_rays import bounce_like_rays, first_frame_primaries

    r = terrain_1m
    b, dev = r.bvh, r.bvh.tri_tab.device
    boxes = (b.sc_min, b.sc_max)
    prim = first_frame_primaries(r, pixel_order(1024, 1024, dev))
    t, k = _check_sweep(b.cluster_min, b.cluster_max, prim, 3.0e38, "1024^2 primaries", boxes)
    assert bool((t > 0).any()) and bool((k == 0x7FFFFFFF).any()) and bool((k != 0x7FFFFFFF).any())
    o, d, tm_c, tm_a = bounce_like_rays(b, 1 << 20, dev, 7)
    bounce = Ray(origin=o, direction=d)
    for t_max, label in ((tm_c, "1M bounce-like rays, closest t_max"), (tm_a, "1M bounce-like rays, shadow t_max"),
                         (3.0e38, "1M bounce-like rays, scalar t_max")):
        _check_sweep(b.cluster_min, b.cluster_max, bounce, t_max, label, boxes)


def test_k_sweep_on_edge_rays(terrain_1m):
    r = terrain_1m
    b, dev = r.bvh, r.bvh.tri_tab.device
    boxes = (b.sc_min, b.sc_max)
    g = torch.Generator(device=dev).manual_seed(3)
    n = 4099
    # above-scene up-rays: t bound 0, key INT32_MAX
    top = b.cluster_max.amax(dim=0) + 1.0
    up = Ray(origin=top.expand(n, 3).contiguous(),
             direction=torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3).contiguous())
    t, k = _check_sweep(b.cluster_min, b.cluster_max, up, 3.0e38, "above-scene up-rays", boxes)
    assert bool((t == 0).all()) and bool((k == 0x7FFFFFFF).all())
    # origins inside clusters, which several superclusters' boxes overlap: ties at near = 0
    cid = torch.randint(0, b.num_clusters, (n,), generator=g, device=dev)
    inside = 0.5 * (b.cluster_min[cid] + b.cluster_max[cid])
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    _check_sweep(b.cluster_min, b.cluster_max, Ray(origin=inside, direction=d), 3.0e38, "origins inside", boxes)
    # directions with components under 1e-20 (and -0.0): axis rays and near-axis rays
    tiny = torch.tensor([0.0, -0.0, 1e-25, -1e-25, 1e-20, -1e-21, 1.0, -1.0], device=dev)
    dirs = tiny[torch.randint(0, tiny.numel(), (n, 3), generator=g, device=dev)]
    dirs[:, 1] = torch.where(dirs.abs().sum(dim=1) == 0, -1.0, dirs[:, 1])
    _check_sweep(b.cluster_min, b.cluster_max, Ray(origin=inside, direction=dirs), 3.0e38, "tiny components", boxes)
    # t_max: scalar +0, -0 and negative, 0-d tensor, (N,) with +0, -0, negatives and NaN; the origins lie inside
    # boxes, so a -0, negative or NaN t_max reaches the t bound, and only a +0 one may skip the sweep
    tm = torch.rand(n, generator=g, device=dev) * 300.0 - 50.0
    tm[::7] = 0.0
    tm[::11] = float("nan")
    tm[::13] = -0.0
    for t_max, label in ((0.0, "scalar 0"), (-0.0, "scalar -0"), (-1.0, "scalar -1"), (25.0, "scalar 25"),
                         (torch.tensor(25.0, device=dev), "0-d 25"), (torch.tensor([25.0], device=dev), "(1,) 25"),
                         (tm, "(N,) with zeros, negatives and NaN")):
        _check_sweep(b.cluster_min, b.cluster_max, Ray(origin=inside, direction=d), t_max, f"t_max {label}", boxes)


@pytest.mark.parametrize("n", [1, 1000])
def test_k_sweep_on_a_ragged_batch(terrain_1m, n):
    b, dev = terrain_1m.bvh, terrain_1m.bvh.tri_tab.device
    _check_sweep(b.cluster_min, b.cluster_max, _seeded_rays(b, n, 17, dev), 3.0e38, f"N = {n}", (b.sc_min, b.sc_max))


def test_k_sweep_on_the_gallery_clusters():
    dev = _card()
    b = _scene_bvh(GALLERY, dev)
    assert b.clustered and b.num_clusters <= 512 and b.num_clusters & (b.num_clusters - 1)
    rays = _seeded_rays(b, 50_000, 23, dev)
    t, k = _check_sweep(b.cluster_min, b.cluster_max, rays, 3.0e38, "gallery", (b.sc_min, b.sc_max))
    assert bool((t > 0).any())


@pytest.mark.parametrize("n_clusters,key_width", [(40_000, "first, middle and last"), (70_000, "first and last"),
                                                  (64 * 32_769 + 5, "first")])
def test_k_sweep_on_synthetic_boxes(n_clusters, key_width):
    """Cluster boxes on a jittered grid: 625 (two chunks of the staged
    boxes, a key with the middle index), 1,094 (a key of the first and last
    box) and 32,770 superclusters (the first box alone)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n_clusters)
    side = int(np.ceil(n_clusters ** (1 / 3)))
    idx = torch.arange(n_clusters, device=dev)
    cell = torch.stack([idx % side, (idx // side) % side, idx // (side * side)], dim=1).float()
    lo = cell * 10.0 + torch.rand((n_clusters, 3), generator=g, device=dev) * 4.0
    hi = lo + 2.0 + torch.rand((n_clusters, 3), generator=g, device=dev) * 9.0
    S = -(-n_clusters // 64)
    sb = cluster._cid_bits(S)
    assert {"first, middle and last": 3 * sb <= 31, "first and last": 3 * sb > 31 >= 2 * sb,
            "first": 2 * sb > 31}[key_width]
    n = 4099 if n_clusters > 100_000 else 65_536
    o = torch.rand((n, 3), generator=g, device=dev) * side * 10.0
    d = torch.randn((n, 3), generator=g, device=dev)
    rays = Ray(origin=o, direction=d / d.norm(dim=-1, keepdim=True))
    t, k = _check_sweep(lo, hi, rays, 3.0e38, f"{n_clusters} synthetic clusters ({S} superclusters)",
                        cluster._superclusters(lo, hi)[4:])
    assert bool((t > 0).any()) and bool((k != 0x7FFFFFFF).any())


@pytest.mark.parametrize("scene,res,depth,superclusters", [(GALLERY, 128, 3, False), (TETRA, 1024, 4, True)],
                         ids=["gallery", "tetra"])
def test_a_frame_through_k_sweep_equals_one_through_the_plain_sweep(scene, res, depth, superclusters, monkeypatch):
    dev = _card()
    r = Renderer(parse_scene(scene), width=res, height=res, mode=RendererType.PATH, path_depth=depth, device=dev)
    assert (r.bvh.num_clusters > 512) == superclusters

    def frame():
        return _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=res, height=res, path_depth=depth,
                           ratio_samples=1, baked_tab=r.baked_tab)

    sk.reset_launch_counts()
    state_k, gb_k, _aux = frame()
    torch.cuda.synchronize(dev)
    assert sk.LAUNCHES["sc_sweep"] == 1 + 2 * depth

    def plain(cmin, cmax, rays, t_max, sc_boxes, key):
        if key:
            k, t = cluster.corridor_keys_and_t_bounds_plain(cmin, cmax, rays, t_max)
            return t, k
        return cluster.ray_t_bounds_plain(cmin, cmax, rays, t_max), None

    monkeypatch.setattr(cluster, "_sweep_cuda", plain)
    state_p, gb_p, _aux = frame()
    torch.cuda.synchronize(dev)
    assert torch.equal(state_k.accum, state_p.accum) and bool((state_k.accum > 0).any())
    assert torch.equal(gb_k.normal, gb_p.normal)


def test_k_sweep_launches_once_a_cluster_trace_in_a_replayed_frame_graph():
    dev = _card()
    r = Renderer(parse_scene(GALLERY), width=64, height=64, mode=RendererType.PATH, path_depth=2, device=dev)
    sk.reset_launch_counts()
    r.render(4)  # the key's eager frame, the capture (which runs nothing), three replays
    r.render(2)
    torch.cuda.synchronize(dev)
    assert r.frame_stages() is not None
    assert sk.LAUNCHES["sc_sweep"] == 6 * (1 + 2 * 2)
    nested = [name for name, _first, _end in r.frame_stages()["nested"]]
    assert nested.count("trace.sweep") == 1 + 2 * 2
    kernels = [k for _pos, k in r.frame_stages()["kernels"]]
    assert kernels.count("supercluster_sweep_kernel") == 1 + 2 * 2
