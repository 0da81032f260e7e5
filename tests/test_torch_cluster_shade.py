"""Kernel K4, the cluster tier's winners to the SurfaceInteraction
(``engine.shade_kernel.cluster_shade_cuda``, ``csrc/cluster_shade.cu``;
its plain version ``engine.shade.shade_winners_plain``, routed by
``engine.shade.trace_closest_si``).

On the CPU: the wrapper refuses CPU tensors, wrong dtypes and shapes,
non-contiguous inputs and misaligned shade tables without building or
loading its library; a CPU cluster-tier trace (the gallery, with textures,
and SPD's tetra at depth 6) shades through the plain pair with and without
``plain=True`` and with an ``active`` mask, loads nothing and counts no
launch; the ctypes ``argtypes`` of K4's and K3's entry points match the
parameters of their ``extern "C"`` signatures.

On a CUDA card (skipped without one), bit-equal to the plain pair run on
the card, field for field: K4 on the 1M-triangle tetra's 1024^2 primary
winners (the baked walk's) and on its 1M corridor-sorted bounce winners,
on the textured gallery's primary and bounce winners, on miss lanes and
``active``-masked lanes, on seeded winners with random rays (degenerate
determinants, t and barycentrics out of range), on ragged batches (n = 0,
1, 1,000); a whole tetra frame through K4 equals one through the plain
pair; K4 launches once a cluster-tier closest trace in a replayed frame
graph (5 a tetra frame at depth 4) and never on Cornell.  This file
imports no JAX, so it runs on the card as
``python -m pytest --noconftest tests/test_torch_cluster_shade.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import types

import pytest
import torch

from optix_renderer_tpu_torch.accel.traverse import trace_closest_winners
from optix_renderer_tpu_torch.core import math as cm
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine import shade
from optix_renderer_tpu_torch.engine import shade_kernel as sk
from optix_renderer_tpu_torch.engine.camera_kernel import pixel_order
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.scene import parse_scene, write_spd_tetra_scene
from optix_renderer_tpu_torch.shading import bsdf
from optix_renderer_tpu_torch.utils import cuda_build
from optix_renderer_tpu_torch.utils.bench_rays import first_frame_primaries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "gallery", "scene.json")
CORNELL = os.path.join(ROOT, "scenes", "cornell", "scene.json")
# SPD's tetra at 1,048,576 triangles (the benchmark's committed copy)
TETRA = os.path.join(ROOT, "portbench", "scenes", "spd-tetra", "scene.json")
CSRC = cuda_build.CSRC_DIR


def _no_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("built or loaded the shading kernels' library")

    monkeypatch.setattr(sk, "cluster_kernel_library", refuse)
    monkeypatch.setattr(sk, "kernel_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "build_library", refuse)


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _assert_same_si(got, want, label: str) -> None:
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {f.name} {g.dtype} {tuple(g.shape)}"
        assert g.is_contiguous(), f"{label}: {f.name} is not contiguous"
        diff = _bits(g) != _bits(w)
        bad = (diff.any(dim=1) if diff.dim() > 1 else diff).nonzero().flatten()
        assert bad.numel() == 0, (f"{label}: {f.name} differs on {bad.numel()} lanes, first {bad[:4].tolist()}: "
                                  f"kernel {g[bad[:4]].tolist()}, plain {w[bad[:4]].tolist()}")


def _cosine_bounce(si, n: int, seed: int) -> Ray:
    """Cosine-sampled rays leaving the hits of ``si`` (miss lanes too: their
    rays are masked by the caller), offset along the normal as the path
    tracer offsets them."""
    g = torch.Generator(device=si.p.device).manual_seed(seed)
    u = torch.rand((2, n), generator=g, device=si.p.device)
    _, to_world = cm.orthonormal_basis(si.n_geom)
    d = cm.normalize(cm.apply_mat(to_world, bsdf.sample_cosine_hemisphere(u[0], u[1])), eps=1e-30)
    return Ray(origin=(si.p + si.n_geom * 1e-3).contiguous(), direction=d.contiguous())


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gallery_cpu():
    return Renderer(parse_scene(GALLERY), width=32, height=32, mode=RendererType.PATH, device="cpu")


@pytest.fixture(scope="module")
def tetra6_cpu(tmp_path_factory):
    path = write_spd_tetra_scene(str(tmp_path_factory.mktemp("tetra6")), depth=6)
    return Renderer(parse_scene(path), width=32, height=32, mode=RendererType.PATH, device="cpu")


def _wrapper_args(r, n=8):
    b = r.bvh
    key = torch.zeros(n, dtype=torch.int32)
    cid = torch.full((n,), -1, dtype=torch.int32)
    return r.device_scene, b.shade_a, b.shade_b, Ray(torch.zeros((n, 3)), torch.ones((n, 3))), key, cid


@pytest.mark.parametrize("case", ["cpu tensors", "float64 origin", "direction (n, 4)", "int64 key",
                                  "cid of another count", "non-contiguous origin", "non-contiguous key",
                                  "shade_a float64", "shade_b (Tp, 6)", "shade_b of another row count",
                                  "mesh_is_light float32", "misaligned shade_a"])
def test_the_wrapper_refuses_without_building(case, gallery_cpu, monkeypatch):
    _no_library(monkeypatch)
    ds, a, b, rays, key, cid = _wrapper_args(gallery_cpu)
    n, match = key.shape[0], "CUDA tensors"
    if case == "float64 origin":
        rays, match = Ray(rays.origin.double(), rays.direction), "origin must be torch.float32"
    elif case == "direction (n, 4)":
        rays, match = Ray(rays.origin, torch.ones((n, 4))), r"direction must be torch.float32 of shape \(8, 3\)"
    elif case == "int64 key":
        key, match = key.long(), "key must be torch.int32"
    elif case == "cid of another count":
        cid, match = cid[:5], r"cid must be torch.int32 of shape \(8,\)"
    elif case == "non-contiguous origin":
        rays, match = Ray(torch.zeros((3, n)).t(), rays.direction), "origin must be contiguous"
    elif case == "non-contiguous key":
        key, match = torch.zeros(2 * n, dtype=torch.int32)[::2], "key must be contiguous"
    elif case == "shade_a float64":
        a, match = a.double(), "shade_a must be torch.float32"
    elif case == "shade_b (Tp, 6)":
        b, match = b[:, :6].contiguous(), "shade_b must be torch.float32 of shape"
    elif case == "shade_b of another row count":
        b, match = b[1:], "shade_b must be torch.float32 of shape"
    elif case == "mesh_is_light float32":
        ds, match = dataclasses.replace(ds, mesh_is_light=ds.mesh_is_light.float()), "mesh_is_light must be torch.bool"
    elif case == "misaligned shade_a":  # a view one float in: contiguous and shaped, but misaligned
        a, match = torch.zeros(a.numel() + 1)[1:].view(a.shape), "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        sk.cluster_shade_cuda(ds, a, b, rays, key, cid)
    assert sk.LAUNCHES["cluster_shade"] == 0


@pytest.mark.parametrize("scene", ["gallery", "tetra"])
def test_a_cpu_cluster_trace_shades_through_the_plain_pair_and_never_loads_k4(scene, gallery_cpu, tetra6_cpu,
                                                                             monkeypatch):
    _no_library(monkeypatch)
    r = gallery_cpu if scene == "gallery" else tetra6_cpu
    ds, b = r.device_scene, r.bvh
    assert b.clustered and (ds.has_textures == (scene == "gallery"))
    sk.reset_launch_counts()
    rays = first_frame_primaries(r, pixel_order(32, 32, "cpu"))
    key, cid, _t, _ = trace_closest_winners(b, rays)
    want = shade.shade_winners_plain(ds, b.shade_a, b.shade_b, rays, key, cid)
    assert bool(want.hit.any()) and bool((~want.hit).any())
    for plain in (False, True):
        _assert_same_si(shade.trace_closest_si(ds, b, rays, plain=plain), want, f"{scene} primaries, plain={plain}")
    # bounce rays, corridor-sorted, with a third of the lanes masked off
    bounce = _cosine_bounce(want, rays.origin.shape[0], 5)
    active = want.hit & (torch.arange(rays.origin.shape[0]) % 3 > 0)
    key_b, cid_b, _t, _ = trace_closest_winners(b, bounce, active=active, coherent=False)
    want_b = shade.shade_winners_plain(ds, b.shade_a, b.shade_b, bounce, key_b, cid_b)
    got_b = shade.trace_closest_si(ds, b, bounce, active=active, coherent=False)
    _assert_same_si(got_b, want_b, f"{scene} bounce rays")
    assert not bool(got_b.hit[~active].any()) and bool(got_b.hit.any())
    if scene == "gallery":  # some hits sample the atlas
        tex = ds.mesh_diffuse_tex[b.shade_a[:, 18].long()[cid.clamp(min=0).long() * 64 + (key & 63).long()]]
        assert bool((want.hit & (tex >= 0)).any())
    assert sk.LAUNCHES == {"brute_shade": 0, "cluster_shade": 0}
    assert not torch.cuda.is_initialized()


def _c_params(source: str, entry: str) -> list[str]:
    """The parameter kinds of ``extern "C" int <entry>(...)`` in csrc/<source>:
    "int" for an int, "ptr" for a pointer."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m is not None, f"no extern \"C\" int {entry}(...) in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return ["ptr" if "*" in p else "int" for p in params if p]


@pytest.mark.parametrize("source,entry,bind", [("cluster_shade.cu", "cluster_shade", sk.bind_cluster_library),
                                               ("brute_shade.cu", "brute_shade", sk.bind_library)],
                         ids=["K4", "K3"])
def test_the_ctypes_argtypes_match_the_c_signature(source, entry, bind):
    import ctypes

    lib = types.SimpleNamespace(**{entry: types.SimpleNamespace()})
    bind(lib)
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    declared = [kinds[t] for t in getattr(lib, entry).argtypes]
    assert declared == _c_params(source, entry)
    assert getattr(lib, entry).restype is ctypes.c_int


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("K4 is a CUDA kernel: it runs only on a CUDA card")
    return torch.device("cuda", 0)


def _check_k4(ds, b, rays: Ray, key, cid, label: str):
    """K4 against the plain pair on the card, bit for bit, one launch;
    returns the plain SurfaceInteraction."""
    sk.reset_launch_counts()
    got = sk.cluster_shade_cuda(ds, b.shade_a, b.shade_b, rays, key, cid)
    want = shade.shade_winners_plain(ds, b.shade_a, b.shade_b, rays, key, cid)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["cluster_shade"] == (1 if key.shape[0] else 0), f"{label}: {sk.LAUNCHES}"
    _assert_same_si(got, want, label)
    return want


def _primaries_and_bounce(r, label: str):
    """K4 on ``r``'s first-frame primary winners (the baked walk, as a frame
    traces them) and on the corridor-sorted winners of cosine bounce rays
    from their hits."""
    ds, b = r.device_scene, r.bvh
    rays = first_frame_primaries(r, pixel_order(r.width, r.height, r.device))
    key, cid, _t, _ = trace_closest_winners(b, rays, baked_tab=r.baked_tab)
    si = _check_k4(ds, b, rays, key, cid, f"{label} primaries")
    assert bool(si.hit.any()) and bool((~si.hit).any())
    bounce = _cosine_bounce(si, rays.origin.shape[0], 11)
    key_b, cid_b, _t, _ = trace_closest_winners(b, bounce, active=si.hit, coherent=False)
    si_b = _check_k4(ds, b, bounce, key_b, cid_b, f"{label} bounce winners")
    assert bool(si_b.hit.any())
    return si, si_b


@pytest.fixture(scope="module")
def tetra_card():
    dev = _card()
    r = Renderer(parse_scene(TETRA), width=1024, height=1024, mode=RendererType.PATH, path_depth=4, device=dev)
    assert r.bvh.clustered and r.bvh.num_tris == 4 ** 10 + 2
    return r


@pytest.mark.chip
def test_k4_on_the_tetras_primary_and_bounce_winners(tetra_card):
    _primaries_and_bounce(tetra_card, "tetra 1024^2")


@pytest.mark.chip
def test_k4_on_the_textured_gallerys_winners():
    dev = _card()
    r = Renderer(parse_scene(GALLERY), width=256, height=256, mode=RendererType.PATH, device=dev)
    assert r.bvh.clustered and r.device_scene.has_textures
    si, _si_b = _primaries_and_bounce(r, "gallery 256^2")
    b = r.bvh
    rays = first_frame_primaries(r, pixel_order(256, 256, dev))
    key, cid, _t, _ = trace_closest_winners(b, rays, baked_tab=r.baked_tab)
    mesh = b.shade_a[:, 18].long()[(cid.clamp(min=0) * 64 + (key & 63)).long()]
    assert bool((si.hit & (r.device_scene.mesh_diffuse_tex[mesh] >= 0)).any()), "no primary hit samples the atlas"


@pytest.mark.chip
def test_k4_on_miss_and_masked_lanes(tetra_card):
    r = tetra_card
    ds, b, dev = r.device_scene, r.bvh, r.device
    n = 4099
    # above-scene up-rays: every lane a miss
    top = b.cluster_max.amax(dim=0) + 1.0
    up = Ray(origin=top.expand(n, 3).contiguous(),
             direction=torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3).contiguous())
    key, cid, _t, _ = trace_closest_winners(b, up)
    si = _check_k4(ds, b, up, key, cid, "above-scene up-rays")
    assert not bool(si.hit.any())
    # primaries of every 256th pixel, over the whole frame, with an active mask: the masked lanes are misses
    # through trace_closest_si too
    rays = first_frame_primaries(r, pixel_order(r.width, r.height, dev)[::256])
    active = torch.arange(rays.origin.shape[0], device=dev) % 3 > 0
    got = shade.trace_closest_si(ds, b, rays, active=active, coherent=False)
    want = shade.trace_closest_si(ds, b, rays, active=active, coherent=False, plain=True)
    _assert_same_si(got, want, "active-masked primaries through trace_closest_si")
    assert not bool(got.hit[~active].any()) and bool(got.hit.any())


@pytest.mark.chip
def test_k4_on_seeded_winners_and_random_rays(tetra_card):
    """Winners that are no ray's closest hit: any sorted triangle, a tenth of
    the lanes misses, rays from anywhere: t, u and v out of range, and the
    padding rows past the last triangle (zero edges, det 0)."""
    r = tetra_card
    ds, b, dev = r.device_scene, r.bvh, r.device
    g = torch.Generator(device=dev).manual_seed(29)
    n = 1 << 20
    tp = b.shade_a.shape[0]
    row = torch.randint(0, tp, (n,), generator=g, device=dev, dtype=torch.int32)
    cid = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, -1, row // 64).to(torch.int32)
    key = (torch.randint(0, 2**31 - 64, (n,), generator=g, device=dev, dtype=torch.int32) & ~63) | (row & 63)
    o = (torch.rand((n, 3), generator=g, device=dev) - 0.5) * 2048.0
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    d[::7, 1:] = 0.0  # axis rays
    si = _check_k4(ds, b, Ray(o, d.contiguous()), key, cid, "seeded winners, random rays")
    assert bool(si.hit.any()) and bool((~si.hit).any())


@pytest.mark.chip
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_k4_on_a_ragged_batch(tetra_card, n):
    r = tetra_card
    half = r.width * r.height // 2
    rays = first_frame_primaries(r, pixel_order(r.width, r.height, r.device)[half:half + n])
    key, cid, _t, _ = trace_closest_winners(r.bvh, rays)
    _check_k4(r.device_scene, r.bvh, rays, key, cid, f"N = {n}")


@pytest.mark.chip
def test_a_tetra_frame_through_k4_equals_one_through_the_plain_pair(tetra_card, monkeypatch):
    r = tetra_card
    depth = r.path_depth

    def frame():
        return _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=r.width, height=r.height,
                           path_depth=depth, ratio_samples=1, baked_tab=r.baked_tab)

    sk.reset_launch_counts()
    state_k, gb_k, _aux = frame()
    torch.cuda.synchronize()
    assert sk.LAUNCHES["cluster_shade"] == 1 + depth

    def plain(ds, shade_a, shade_b, rays, key, cid):
        return shade.shade_winners_plain(ds, shade_a, shade_b, rays, key, cid)

    monkeypatch.setattr(sk, "cluster_shade_cuda", plain)
    state_p, gb_p, _aux = frame()
    torch.cuda.synchronize()
    assert torch.equal(state_k.accum, state_p.accum) and bool((state_k.accum > 0).any())
    for f in dataclasses.fields(gb_k):
        assert torch.equal(getattr(gb_k, f.name), getattr(gb_p, f.name)), f.name


@pytest.mark.chip
def test_k4_launches_once_a_cluster_trace_in_a_replayed_frame_graph(tetra_card):
    dev = _card()
    r = tetra_card
    sk.reset_launch_counts()
    r.render(4)  # the key's eager frame, the capture (which runs nothing), three replays
    r.render(2)
    torch.cuda.synchronize(dev)
    assert sk.LAUNCHES == {"brute_shade": 0, "cluster_shade": 6 * (1 + 4)}
    kernels = [k for _pos, k in r.frame_stages()["kernels"]]
    assert kernels.count("cluster_shade_kernel") == 1 + 4
    nested = [name for name, _first, _end in r.frame_stages()["nested"]]
    assert nested.count("trace.shade") == 1 + 4
    # Cornell takes the brute tier: K3, never K4
    rc = Renderer(parse_scene(CORNELL), width=64, height=64, mode=RendererType.PATH, path_depth=4, device=dev)
    sk.reset_launch_counts()
    rc.render(3)
    torch.cuda.synchronize(dev)
    assert sk.LAUNCHES["cluster_shade"] == 0 and sk.LAUNCHES["brute_shade"] > 0



def test_the_shade_rows_are_whole_16_byte_words():
    """K4 reads a shade_a row (20 floats) and a shade_b row (8) as float4
    words: each is a whole number of them."""
    from optix_renderer_tpu_torch.accel.build import SHADE_A_COLS, SHADE_B_COLS

    assert (SHADE_A_COLS * 4) % 16 == 0 and (SHADE_B_COLS * 4) % 16 == 0
    assert sk.BYTES_WINNER + sk.BYTES_WINNER_ROW == 214 and sk.BYTES_WINNER_ROW == (SHADE_A_COLS + SHADE_B_COLS) * 4
