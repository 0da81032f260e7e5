"""RATIO's stages and its live-ray counter, and the benchmark's three-light
tetra scene, on the CPU (no JAX).

* A profiled RATIO frame on the cluster tier opens ``frame.ratio.ltc``,
  ``.sample``, ``.visibility`` and ``.combine`` once each, in that order,
  and the cluster tier's ``trace.*`` spans of the RATIO work only inside
  ``frame.ratio.visibility``.
* ``Renderer.metrics``' ``ratio_live_shadow_rays`` equals a count made on
  the host from the frames' primary hits, and ``ratio_shadow_rays`` the
  rays of the frames' visibility batches; ``profile_frames`` reads both a
  frame.
* The stages and the counter change no value: ``ratio_color``'s buffers
  and RNG state are bit-equal to the integrator's body written out here
  as it was before them, and a profiled render's accumulator and buffers
  equal an unprofiled one's.
* Only the visibility rays a buffer reads are traced: on both tiers (the
  three-light tetra on the cluster tier's plain path, Cornell-3, whose
  light is in view, on the brute tier) the batch's t bound is exactly +0 on
  the rays of miss and light lanes and nowhere else, the buffers and the
  colour are bit-equal (``int32`` views) to the body above, which traces
  every ray, and the rays with a +0 bound number ``ratio_shadow_rays``
  less ``ratio_live_shadow_rays``.
* ``portbench/scenes/spd-tetra-3lights/scene.json`` names the same
  ``tetra.obj`` as ``spd-tetra``, and its lights are the configuration's.
* On a CUDA card (skipped without one; run it with
  ``python -m pytest --noconftest -m chip tests/test_torch_ratio_stages.py``):
  a 1024^2 RATIO frame of that scene replayed from its frame graph equals
  its eager ``_frame_impl`` frame bit for bit, and the stage map covers
  every node once and maps every replayed operation; and in one 1024^2
  frame of it the buffers equal the body's that traces every ray, K-sweep's
  t bound of the batch is bit-equal to the plain sweep's on all 4,194,304
  lanes, and B4's work counters read no slab and no triangle test on the
  rays of miss and light lanes.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from optix_renderer_tpu_torch.accel import cluster
from optix_renderer_tpu_torch.accel import cluster_trace as ct
from optix_renderer_tpu_torch.accel.traverse import trace_any
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine.camera_kernel import camera_rng
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.engine.shade import trace_closest_si
from optix_renderer_tpu_torch.integrators import ratio
from optix_renderer_tpu_torch.integrators.ltc_direct import ltc_direct
from optix_renderer_tpu_torch.integrators.path_kernel import RAY_EPS
from optix_renderer_tpu_torch.scene import parse_scene, write_spd_tetra_scene
from optix_renderer_tpu_torch.scene.obj_loader import load_obj
from optix_renderer_tpu_torch.shading import ltc
from optix_renderer_tpu_torch.utils import profile_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "portbench", "scenes")
TETRA3 = os.path.join(SCENES, "spd-tetra-3lights")
RES = 16
STAGES = ["frame.ratio.ltc", "frame.ratio.sample", "frame.ratio.visibility", "frame.ratio.combine"]


@pytest.fixture(scope="module")
def tetra3(tmp_path_factory):
    """SPD's tetra at depth 5 (4,096 triangles: with the six light
    triangles, the cluster tier) under the benchmark scene's three lights."""
    out = str(tmp_path_factory.mktemp("tetra3"))
    path = write_spd_tetra_scene(out, depth=5)
    for name in ("light.obj", "light.mtl"):
        shutil.copy(os.path.join(TETRA3, name), os.path.join(out, name))
    return parse_scene(path)


@pytest.fixture(scope="module")
def cornell3():
    """Cornell-3: three lights of different emission, one in view (14 lanes
    at 32^2, every other lane a hit), 36 triangles: the brute tier."""
    return parse_scene(os.path.join(ROOT, "scenes", "cornell3", "scene.json"))


# each scene's resolution and tier (True: the cluster tier)
TIERS = {"tetra3": (RES, True), "cornell3": (32, False)}


def _renderer(scene, **kw):
    r = Renderer(scene, width=RES, height=RES, mode=RendererType.RATIO, ratio_samples=4, device="cpu", **kw)
    assert r.bvh.clustered and r.device_scene.num_lights == 6
    return r


def _tree(prof) -> list:
    """The program's spans as (name, parent name), in start order."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.is_user_annotation()),
                   key=lambda s: (s[0], -s[1]))
    out, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out


def test_a_profiled_ratio_frame_opens_the_four_stages_in_order(tetra3):
    r = _renderer(tetra3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render(2)
    tree = _tree(prof)
    frame = ["frame.camera_rng", "frame.primary_trace", *STAGES, "frame.gbuffers", "frame.accumulate"]
    assert [name for name, parent in tree if parent == "frame_graph.eager"] == frame * 2
    assert not [name for name, _p in tree if name == "frame.ratio"]  # split, not kept whole
    parents = {}
    for name, parent in tree:
        parents.setdefault(name, set()).add(parent)
    assert parents["ltc.direct"] == {"frame.ratio.ltc"}
    traced = {p for name, p in tree if name.startswith("trace.")}
    assert traced == {"frame.primary_trace", "frame.ratio.visibility"}  # the RATIO work's traces: visibility
    assert "frame.ratio.visibility" in parents["trace.sweep"]


def _primary_hits(r, frame=None):
    frame = r.state.accum_id if frame is None else frame
    rays, rng = camera_rng(r.state.camera, frame, r.width, r.height, 0, r.height, plain=True)
    return rays, trace_closest_si(r.device_scene, r.bvh, rays, plain=True), rng


def _host_live(r, frame) -> int:
    _rays, si, _rng = _primary_hits(r, frame)
    return int(np.count_nonzero(si.hit.numpy() & ~si.is_light.numpy()))


def test_the_live_shadow_rays_equal_a_host_count(tetra3):
    r = _renderer(tetra3)
    want = 0
    for i in range(3):
        want += _host_live(r, i)
        r.render(1)
    m = r.metrics
    assert 0 < want < 3 * RES * RES
    assert m["ratio_live_shadow_rays"] == 4 * want
    assert m["ratio_shadow_rays"] == 3 * 4 * RES * RES
    r.set_camera(tetra3.cameras[0])
    r.render(2)  # one call of two frames: its sum joins the count
    want += _host_live(r, 0) + _host_live(r, 1)
    assert r.metrics["ratio_live_shadow_rays"] == 4 * want
    assert r.metrics["ratio_shadow_rays"] == 5 * 4 * RES * RES


def _ratio_color_before_the_stages(ds, bvh, rays, si, rng_state, n_samples=4):
    """``ratio_color``'s body as it was before its stages, its counter and
    its mask: every visibility ray is traced."""
    ltc_color = ltc_direct(ds, rays, si)
    to_local, wo_local = ltc.shading_frame(rays.origin, si.p, si.n_geom)
    n = rays.origin.shape[0]
    shadow_origin = si.p + si.n_geom * RAY_EPS
    rng = rng_state
    contribs, dirs, dists = [], [], []
    for _ in range(n_samples):
        c, ldir, dist, rng = ratio._stochastic_direct_sample(ds, si, shadow_origin, wo_local, to_local, rng)
        contribs.append(c)
        dirs.append(ldir)
        dists.append(dist)
    all_rays = Ray(origin=shadow_origin.repeat(n_samples, 1), direction=torch.cat(dirs, dim=0))
    occ = trace_any(bvh, all_rays, t_max=torch.cat(dists, dim=0) * (1.0 - 1e-3)).reshape(n_samples, n)
    no_vis = sum(contribs) / n_samples
    direct = sum(torch.where(occ[k][:, None], 0.0, contribs[k]) for k in range(n_samples)) / n_samples
    g_direct = direct.mean(dim=-1, keepdim=True)
    g_no_vis = no_vis.mean(dim=-1, keepdim=True)
    is_l, hit = si.is_light[:, None], si.hit[:, None]
    ltc_buf = torch.where(hit, torch.where(is_l, si.emit, ltc_color), ds.miss_color[None, :])
    emit_gray = si.emit.mean(dim=-1, keepdim=True)
    sto_d = torch.where(hit, torch.where(is_l, emit_gray, g_direct), 0.0)
    sto_n = torch.where(hit, torch.where(is_l, emit_gray, g_no_vis), 0.0)
    return ltc_buf, rng, {"ltc": ltc_buf, "sto_direct": sto_d, "sto_no_vis": sto_n}


def test_the_stages_and_the_counter_change_no_value(tetra3):
    r = _renderer(tetra3)
    rays, si, rng = _primary_hits(r)
    color, rng_out, aux, live = ratio.ratio_color(r.device_scene, r.bvh, rays, si, rng, n_samples=4)
    want_color, want_rng, want_aux = _ratio_color_before_the_stages(r.device_scene, r.bvh, rays, si, rng)
    assert torch.equal(color, want_color) and torch.equal(rng_out, want_rng)
    assert sorted(aux) == sorted(want_aux)
    for k in want_aux:
        assert torch.equal(aux[k], want_aux[k]), k
    assert live.dtype == torch.int64 and live.dim() == 0
    assert int(live) == int((si.hit & ~si.is_light).sum())

    plain, profiled = _renderer(tetra3), _renderer(tetra3)
    plain.render(2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled.render(2)
    assert torch.equal(plain.state.accum, profiled.state.accum)
    assert sorted(plain.aux) == ["ltc", "sto_direct", "sto_no_vis"]
    for k in plain.aux:
        assert torch.equal(plain.aux[k], profiled.aux[k]), k
    state, _gb, aux = _frame_impl(plain.state, plain.device_scene, plain.bvh, mode=RendererType.RATIO, width=RES,
                                  height=RES, path_depth=plain.path_depth, ratio_samples=4)
    assert sorted(aux) == ["ltc", "sto_direct", "sto_no_vis"]  # the frame's buffers alone


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)  # a signed zero shows


def _record_bounds(monkeypatch) -> list:
    """Have ``ratio_color`` leave each visibility batch's t bound in the
    returned list; the trace is unchanged."""
    bounds = []

    def record(bvh, rays, t_max):
        bounds.append(t_max.clone())
        return trace_any(bvh, rays, t_max=t_max)

    monkeypatch.setattr(ratio, "trace_any", record)
    return bounds


def _tier_renderer(request, scene_name):
    res, clustered = TIERS[scene_name]
    r = Renderer(request.getfixturevalue(scene_name), width=res, height=res, mode=RendererType.RATIO,
                 ratio_samples=4, device="cpu")
    assert r.bvh.clustered == clustered
    return r


@pytest.mark.parametrize("scene_name", sorted(TIERS))
def test_only_the_visibility_rays_a_buffer_reads_are_traced(scene_name, request, monkeypatch):
    r = _tier_renderer(request, scene_name)
    rays, si, rng = _primary_hits(r)
    read = si.hit & ~si.is_light
    unread = ~read
    assert bool(read.any()) and not bool(read.all())
    bounds = _record_bounds(monkeypatch)
    color, rng_out, aux, live = ratio.ratio_color(r.device_scene, r.bvh, rays, si, rng, n_samples=4)
    want_color, want_rng, want_aux = _ratio_color_before_the_stages(r.device_scene, r.bvh, rays, si, rng)
    assert torch.equal(_bits(color), _bits(want_color)) and torch.equal(rng_out, want_rng)
    for k in want_aux:
        assert torch.equal(_bits(aux[k]), _bits(want_aux[k])), k
    assert len(bounds) == 1 and bounds[0].shape == (4 * r.width * r.height,)
    zero = (_bits(bounds[0]) == 0).view(4, -1)
    assert torch.equal(zero, unread[None].expand(4, -1))  # exactly +0 on the unread lanes' rays, nowhere else
    assert int(live) == int(read.sum())


@pytest.mark.parametrize("scene_name", sorted(TIERS))
def test_the_untraced_rays_are_the_counters_difference(scene_name, request, monkeypatch):
    r = _tier_renderer(request, scene_name)
    bounds = _record_bounds(monkeypatch)
    r.render(2)
    r.render(1)
    m = r.metrics
    zero = sum(int((_bits(t) == 0).sum()) for t in bounds)
    assert len(bounds) == 3 and m["ratio_shadow_rays"] == 3 * 4 * r.width * r.height
    assert 0 < zero == m["ratio_shadow_rays"] - m["ratio_live_shadow_rays"]


def test_the_three_light_scene_shares_the_tetra():
    with open(os.path.join(TETRA3, "scene.json")) as f:
        three = json.load(f)
    with open(os.path.join(SCENES, "spd-tetra", "scene.json")) as f:
        one = json.load(f)
    tetra = os.path.realpath(os.path.join(TETRA3, three["surface_geometry"]))
    assert tetra == os.path.realpath(os.path.join(SCENES, "spd-tetra", one["surface_geometry"]))
    assert {k: v for k, v in three.items() if k != "surface_geometry"} == \
        {k: v for k, v in one.items() if k != "surface_geometry"}  # the same camera and size
    meshes = load_obj(os.path.join(TETRA3, three["area_lights"])).meshes
    emit = np.asarray([m.emit for m in meshes], np.float64)
    cornell3 = np.asarray([[17.0, 12.0, 4.0], [2.0, 6.0, 14.0], [3.0, 12.0, 3.0]])
    assert len(meshes) == 3 and sum(len(m.index) for m in meshes) == 6
    np.testing.assert_allclose(emit / cornell3, 1.5)  # cornell3's colours and ratios
    for m in meshes:
        assert np.allclose(np.asarray(m.normal)[:, 1], -1.0)  # facing down
        assert np.asarray(m.vertex)[:, 1].min() > 512.0  # above the tetra's top edge
    with open(os.path.join(ROOT, "portbench", "configs", "spd-tetra-1m-3lights.json")) as f:
        cfg = json.load(f)
    assert cfg["triangles"] == 4 ** 10 + 6 and cfg["lights"] == 6 and cfg["reduced"] == []


def test_profile_frames_reads_the_counter_beside_its_tetra3_preset(tetra3):
    assert profile_frames.CONFIGS["tetra3"] == ("spd_tetra3", "RATIO", 1024, 4)
    r = _renderer(tetra3)
    r.render(2)
    line = profile_frames.ratio_shadow_rays(r.metrics)
    live = _host_live(r, 0) + _host_live(r, 1)
    assert line == {"frames": 2, "traced_per_frame": 4 * RES * RES, "live_per_frame": 4 * live / 2,
                    "live_share": live / (2 * RES * RES)}


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("the frame graph and its stage map exist only on a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
def test_a_replayed_tetra3_ratio_frame_equals_its_eager_frame_and_maps_every_node(cuda):
    r = Renderer(parse_scene(os.path.join(TETRA3, "scene.json")), width=1024, height=1024, mode=RendererType.RATIO,
                 ratio_samples=4, device="cuda")
    assert r.bvh.clustered and r.bvh.num_tris == 4 ** 10 + 6 and r.baked_tab is not None
    r.render(2)  # the key's eager frame, then the capture and a replay
    start = r.state
    state, _gb, aux = _frame_impl(start, r.device_scene, r.bvh, mode=RendererType.RATIO, width=1024, height=1024,
                                  path_depth=r.path_depth, ratio_samples=4, baked_tab=r.baked_tab)
    r.render(1)  # a replay from the same state
    assert torch.equal(r.state.accum, state.accum)
    for k in aux:
        assert torch.equal(r.aux[k], aux[k]), k
    stage_map = r.frame_stages()
    first = [s[1] for s in stage_map["stages"]]
    assert first == [0] + [s[2] for s in stage_map["stages"][:-1]] and stage_map["stages"][-1][2] == stage_map["nodes"]
    names = [s[0] for s in stage_map["stages"]]
    assert [n for n in names if n.startswith("frame.ratio.")] == STAGES
    nested = [(name, first, end) for name, first, end in stage_map["nested"]]
    vis = next((a, b) for name, a, b in stage_map["stages"] if name == "frame.ratio.visibility")
    assert any(name == "trace.sweep" and vis[0] <= a < b <= vis[1] for name, a, b in nested)
    kernels = dict((k, pos) for pos, k in stage_map["kernels"])
    ltc_stage = next((a, b) for name, a, b in stage_map["stages"] if name == "frame.ratio.ltc")
    assert ltc_stage[0] <= kernels["ltc_kernel"] < ltc_stage[1]
    assert vis[0] <= kernels["any_walk_kernel"] < vis[1]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(2)
    b = profile_frames.stage_breakdown(*profile_frames.profiled_events(prof), 2, stage_map)
    assert b["unmapped_replays"] == 0
    assert set(STAGES) <= set(b["frame_stages"]) and b["stages"]["B6"]["calls_per_frame"] == 1
    m = r.metrics
    assert 0 < m["ratio_live_shadow_rays"] < m["ratio_shadow_rays"] and m["ratio_shadow_rays"] % (4 << 20) == 0


@pytest.mark.chip
def test_a_tetra3_frame_traces_only_the_visibility_rays_a_buffer_reads(cuda, monkeypatch):
    r = Renderer(parse_scene(os.path.join(TETRA3, "scene.json")), width=1024, height=1024, mode=RendererType.RATIO,
                 ratio_samples=4, device="cuda")
    b = r.bvh
    rays, si, rng = _primary_hits(r)
    batches = []

    def record(bvh, rays_, t_max):
        batches.append((rays_, t_max.clone()))
        return trace_any(bvh, rays_, t_max=t_max)

    monkeypatch.setattr(ratio, "trace_any", record)
    color, rng_out, aux, live = ratio.ratio_color(r.device_scene, b, rays, si, rng, n_samples=4)
    want_color, want_rng, want_aux = _ratio_color_before_the_stages(r.device_scene, b, rays, si, rng)
    assert torch.equal(_bits(color), _bits(want_color)) and torch.equal(rng_out, want_rng)
    for k in want_aux:
        assert torch.equal(_bits(aux[k]), _bits(want_aux[k])), k
    ((batch, t_max),) = batches
    n = 4 << 20
    read = (si.hit & ~si.is_light)[None].expand(4, -1).reshape(n)
    assert torch.equal(_bits(t_max) == 0, ~read) and 0 < int(live) < n // 4
    o, d = batch.origin.contiguous(), batch.direction.contiguous()
    t_eff = cluster.ray_t_bounds(b.cluster_min, b.cluster_max, batch, t_max, sc_boxes=(b.sc_min, b.sc_max))
    step = 1 << 20  # the plain sweep in slices: the same bits, a quarter of the memory
    want = torch.cat([cluster.ray_t_bounds_plain(b.cluster_min, b.cluster_max,
                                                 Ray(origin=o[s:s + step], direction=d[s:s + step]), t_max[s:s + step])
                      for s in range(0, n, step)])
    assert torch.equal(_bits(t_eff), _bits(want))
    assert bool((t_eff[~read] == 0).all())
    work = {}
    for name, lanes in (("batch", slice(None)), ("unread", ~read), ("read", read)):
        w = torch.zeros(4, dtype=torch.int64, device=cuda)
        ct.trace_any_walk_cuda(b.tri_tab, b.cluster_min, b.cluster_max, b.sc_min, b.sc_max, o[lanes].contiguous(),
                               d[lanes].contiguous(), t_eff[lanes].contiguous(), work=w)
        work[name] = w.tolist()
    # slab tests, triangle tests and their lane slots: none for an unread ray, so the batch's are the read rays'
    assert work["unread"] == [0, 0, 0, 0]
    assert work["batch"] == work["read"] and min(work["read"]) > 0
