"""SPD's ``tetra`` (the Sierpinski tetrahedron of Haines's Standard
Procedural Databases) and the cluster tier's stages in the frame graph's
stage map.

* ``scene.procedural.write_spd_tetra_scene``: its counts, integer grid,
  bounding box, outward winding and depth-first order at depths 2, 3 and 6,
  held against a recursion written out here; the benchmark's committed copy
  (``portbench/scenes/spd-tetra/``) is its output byte for byte.
* The port's CPU path (the cluster tier above 4,096 triangles) on the
  depth-6 tetra against the benchmark's plain reference
  (``portbench/reference/``), within the benchmark cell's ``rel_tol``;
  ``portbench/edge_ties.py`` there and on hand-built answers.
* ``utils.launches.stage_map``'s ``trace.*`` stages nested in the
  ``frame.*`` ones, on a stand-in node counter, and
  ``profile_frames.stage_breakdown`` staging replayed operations by them;
  ``profile_frames.walk_work`` on a stand-in frame's walk launches.
* On a CUDA card (skipped without one; no JAX here, so run it with
  ``python -m pytest --noconftest -m chip tests/test_torch_spd_tetra.py``):
  a captured tetra frame's stage map names the cluster tier's stages and
  maps every replayed operation.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from optix_renderer_tpu_torch.scene import parse_scene, write_spd_tetra_scene
from optix_renderer_tpu_torch.scene.procedural import SPD_TETRA_CORNERS
from optix_renderer_tpu_torch.utils import launches, profile_frames
from optix_renderer_tpu_torch.utils.launches import span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "portbench", "scenes", "spd-tetra")
FILES = ("tetra.obj", "tetra.mtl", "light.obj", "light.mtl", "scene.json")
REL_TOL = 1e-3  # portbench/checks/tetra.path_progressive.json


def _read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] == "v":
                verts.append([int(t) for t in tok[1:]])  # an integer grid: int() refuses "1.5"
            elif tok and tok[0] == "f":
                faces.append([int(t) - 1 for t in tok[1:]])
    return np.asarray(verts, np.int64), np.asarray(faces, np.int64)


def _leaves(corners, depth):
    """The leaves' corners, depth first: each tetrahedron's copy at its corner i, i = 0..3."""
    if depth == 0:
        yield corners
        return
    for i in range(4):
        yield from _leaves([(c + corners[i]) // 2 for c in corners], depth - 1)


@pytest.mark.parametrize("depth", [2, 3, 6])
def test_the_writer_gives_spd_tetra(tmp_path, depth):
    path = write_spd_tetra_scene(str(tmp_path), depth=depth)
    verts, faces = _read_obj(os.path.join(tmp_path, "tetra.obj"))
    assert faces.shape == (4 ** (depth + 1), 3) and verts.shape == (2 * 4 ** depth + 2, 3)
    assert len({tuple(v) for v in verts.tolist()}) == len(verts)  # shared vertices, none twice
    assert verts.min() == -512 and verts.max() == 512
    assert sorted(np.unique(faces).tolist()) == list(range(len(verts)))
    # vertices numbered in order of first use
    first = [np.flatnonzero(faces.reshape(-1) == i)[0] for i in range(len(verts))]
    assert first == sorted(first)
    # depth-first leaves, four faces each; face j leaves out corner j and faces away from it
    leaves = list(_leaves([c for c in SPD_TETRA_CORNERS], depth))
    tri = verts[faces].reshape(-1, 4, 3, 3)
    for leaf, got in zip(leaves, tri):
        for j in range(4):
            assert {tuple(p) for p in got[j].tolist()} == {tuple(leaf[k]) for k in range(4) if k != j}
            a, b, c = got[j].astype(np.float64)
            assert np.dot(np.cross(b - a, c - a), leaf[j] - a) < 0
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["surface_geometry"] == "tetra.obj" and cfg["area_lights"] == "light.obj" and len(cfg["cameras"]) == 1
    scene = parse_scene(path)
    assert sum(len(m.index) for m in scene.model.meshes if not m.is_light) == 4 ** (depth + 1)
    assert [len(m.index) for m in scene.model.meshes if m.is_light] == [2]


def test_the_committed_scene_is_the_writers_output(tmp_path):
    write_spd_tetra_scene(str(tmp_path), depth=9)
    for name in FILES:
        with open(os.path.join(tmp_path, name), "rb") as a, open(os.path.join(COMMITTED, name), "rb") as b:
            assert hashlib.sha256(a.read()).hexdigest() == hashlib.sha256(b.read()).hexdigest(), name


def test_the_cpu_path_agrees_with_the_plain_reference_on_the_depth_6_tetra(tmp_path):
    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene.config import SceneCamera
    from portbench.harness import check, traffic
    from portbench.reference import render as ref
    from portbench.reference.scene import load_scene

    path = write_spd_tetra_scene(str(tmp_path), depth=6)
    width, height, frames = 32, 24, 2
    r = Renderer(parse_scene(path), width=width, height=height, mode=RendererType.PATH, path_depth=4, device="cpu")
    assert r.bvh.clustered and r.bvh.num_tris == 4 ** 7 + 2
    tables = load_scene(path)
    cam = traffic.orbit_camera(tables["cameras"][0], 7.5)
    r.set_camera(SceneCamera(from_=cam[0], at=cam[1], up=cam[2], cos_fovy=cam[3]))
    r.render(frames)
    img = r.image().reshape(-1, 3).astype(np.float64)
    want = ref.render_pixels(ref.RefScene(tables, "cpu"), cam, width, height, np.arange(width * height), frames)
    assert (want.max(axis=1) > 0).mean() > 0.5  # the tetra fills most of the frame
    assert check.off_share(img, want, REL_TOL) == 0.0


def test_edge_ties_finds_the_cpu_path_and_the_reference_apart_nowhere_on_the_depth_6_tetra(tmp_path):
    """``portbench/edge_ties.py`` at 16x12 on the depth-6 tetra: every one of
    the port's triangles is one of the reference's, and on the CPU (the plain walks) every
    trace answer equals the reference's, so the swapped render is the
    reference's and no pixel is off."""
    from portbench import edge_ties

    path = write_spd_tetra_scene(str(tmp_path), depth=6)
    lines = []
    over = {"config": {"scene": {"files": path}, "width": 16, "height": 12},
            "traffic": {"frames_per_request": 2, "frames_per_call": 2}, "check": {"pixels": 192}}
    assert edge_ties.edge_ties("tetra.path_progressive", 2147491999, "cpu", 1, over, log=lines.append) == 0
    line = json.loads(lines[0])
    assert set(line["off_pixels_pct"].values()) == {0.0} and line["flagged_pixels_pct"] == 0.0
    for kind in ("primary", "shadow", "bounce"):
        k = line["rays"][kind]
        assert k["rays"] > 0 and k["differ"] == 0 and k["same_tri_t_rel_max"] == 0.0


def test_edge_ties_classifies_differing_answers():
    """``edge_ties.Comparer`` on two triangles that share the edge x + y = 1
    (z = 0) and one below them: a ray down through the edge answered by
    either triangle is a tie; a hit at the edge against a miss, or against
    the far triangle, is a graze; a hit 0.2 from every edge against a miss
    or against the far triangle is other; a lane with any of them is
    flagged."""
    from portbench import edge_ties

    v64 = torch.tensor([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[1, 0, 0], [1, 1, 0], [0, 1, 0]],
                        [[-5, -5, -3], [5, -5, -3], [-5, 5, -3]]], dtype=torch.float64)
    o = torch.tensor([[0.5, 0.5, 1.0], [0.5, 0.5, 1.0], [0.2, 0.2, 1.0], [0.2, 0.2, 1.0], [0.3, 0.3, 1.0],
                      [1.0, 0.5, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 6)
    ids_ref, ids_port = torch.tensor([0, 0, 0, 0, 0, 1]), torch.tensor([1, -1, -1, 2, 0, 2])
    t_max = torch.tensor([3e38, 3e38, 3e38, 3e38, 0.0, 3e38])  # lane 4 is dead

    def answer(ids):
        return torch.ones(6), ids, torch.zeros(6), torch.zeros(6)

    c = edge_ties.Comparer(lambda *a: answer(ids_ref), None, None, v64, torch.arange(3), depth=1)
    c._port = lambda kind, *a: answer(ids_port)
    got = c(None, o, d, t_max, True)
    assert torch.equal(got[1], ids_port)  # the path goes on with the port's answers
    k = c.kinds["primary"]
    assert (k["rays"], k["differ"], k["tie"], k["graze"], k["other"], k["shares_vertex"]) == (5, 5, 1, 2, 2, 1)
    assert k["differ_ulps_hist"] == [3, 0, 0, 0, 0, 0, 2]  # on an edge; 0.2 from every edge at a reach of 1
    assert edge_ties.reference_ids(v64.float().numpy()[[2, 0, 1]], v64.float().numpy()).tolist() == [2, 0, 1]
    assert c.flags[0].tolist() == [True, True, True, True, False, True]


def _node_counter(monkeypatch):
    nodes = [0]
    monkeypatch.setattr(launches, "capture_node_counter", lambda: lambda: nodes[0])

    def make(n=1):
        nodes[0] += n

    return nodes, make


def test_trace_stages_nest_in_the_frame_stages_and_cover_each_node_once(monkeypatch):
    nodes, make = _node_counter(monkeypatch)
    with launches.stage_map("frame_graph.capture") as st:
        make()  # the capture's own
        with span("frame.primary_trace"):
            with span("trace.sweep"):
                make(3)
            make()  # the walk kernel: the frame stage's own
            with span("trace.shade"):
                make(2)
        with span("frame.bounce.shadow"):
            with span("trace.sweep"):
                make(2)
            with span("trace.sort"):
                make()
            make()
            with span("trace.sweep"):
                make()
        with span("frame.bounce.trace"):
            with span("trace.sweep"):  # adjacent to the shadow's last sweep, in another stage: its own entry
                make(2)
            with span("trace.sweep"):  # adjacent in one stage: one entry
                make()
        with span("frame.bounce.count"):
            with span("trace.sort"):
                pass  # no node: no entry
        with span("trace.sort"):  # outside every frame stage: nested in the capture's own
            with span("frame.finish"):  # a frame stage inside it takes its nodes whole
                make()
            make()
    assert st["nodes"] == nodes[0] == 17
    assert [tuple(s) for s in st["stages"]] == [
        ("frame_graph.capture", 0, 1), ("frame.primary_trace", 1, 7), ("frame.bounce.shadow", 7, 12),
        ("frame.bounce.trace", 12, 15), ("frame.finish", 15, 16), ("frame_graph.capture", 16, 17)]
    assert [tuple(s) for s in st["nested"]] == [
        ("trace.sweep", 1, 4), ("trace.shade", 5, 7), ("trace.sweep", 7, 9), ("trace.sort", 9, 10),
        ("trace.sweep", 11, 12), ("trace.sweep", 12, 15), ("trace.sort", 16, 17)]
    # every node in one stage, at most one nested stage, and that inside its stage's entry
    owner = [None] * st["nodes"]
    for i, (_stage, first, end) in enumerate(st["stages"]):
        assert first < end
        owner[first:end] = [i] * (end - first)
    assert None not in owner and [s[1] for s in st["stages"]] == [0] + [s[2] for s in st["stages"][:-1]]
    seen = set()
    for _stage, first, end in st["nested"]:
        assert first < end and len({owner[k] for k in range(first, end)}) == 1
        assert seen.isdisjoint(range(first, end))
        seen.update(range(first, end))


def test_outside_a_capture_a_trace_span_is_the_shared_null_context():
    assert span("trace.sweep") is span("frame.bounce.trace") is launches._NULL


GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
B3 = "void (anonymous namespace)::closest_walk_kernel<false, false, (anonymous namespace)::Tri>(Args)"


def test_replayed_operations_take_their_nested_trace_stage():
    """``stage_breakdown`` on hand-built events (ns): two replays of a
    four-node graph whose map nests ``trace.sweep`` and ``trace.shade`` in
    ``frame.primary_trace``; the walk kernel at node 2 counts by name."""
    stage_map = {"nodes": 4, "stages": [["frame.camera_rng", 0, 1], ["frame.primary_trace", 1, 4]],
                 "nested": [["trace.sweep", 1, 2], ["trace.shade", 3, 4]], "kernels": [[2, "closest_walk_kernel"]]}
    calls = {7: (0, "cudaGraphLaunch", 1), 8: (1000, "cudaGraphLaunch", 1)}
    ops = []
    for corr, t0 in ((7, 100), (8, 1100)):
        ops += [(t0, 10, GLUE, corr), (t0 + 10, 20, GLUE, corr), (t0 + 30, 40, B3, corr), (t0 + 70, 30, GLUE, corr)]
    b = profile_frames.stage_breakdown([], calls, ops, 2, stage_map)
    assert b["unmapped_replays"] == 0
    assert b["glue_stages"] == pytest.approx({"trace.shade": 30e-6, "trace.sweep": 20e-6, "frame.camera_rng": 10e-6})
    assert b["frame_stages"]["frame.primary_trace"] == pytest.approx(40e-6)  # B3, the stage's own
    assert b["stages"]["sweep"]["device_ms_per_frame"] == pytest.approx(20e-6)
    assert b["stages"]["shade"]["device_ms_per_frame"] == pytest.approx(30e-6)
    assert b["stages"]["B3_walk"]["calls_per_frame"] == 1


def test_walk_work_relaunches_each_walk_with_its_counters(monkeypatch):
    """``profile_frames.walk_work`` on a stand-in frame whose walk launches
    take their counters as the walk wrappers do (``_launch_work``,
    ``_record_work``): a fresh counter only inside ``work_records`` and only
    where the caller gave none; the counts come out per live ray."""
    from optix_renderer_tpu_torch.accel import cluster_trace as ct

    b, t = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 1.0, 1.0]])
    o, d = torch.zeros(4, 3), torch.tensor([[1.0, 0.0, 0.0]] * 4)
    key0 = torch.tensor([5.0, 0.0, 5.0, 5.0]).view(torch.int32) | 63  # lane 1 dead
    t_max = torch.tensor([1.0, 0.0, 0.0, 2.0])  # two live lanes
    assert ct._launch_work(None, o.device) == (None, None)  # no records open: nothing counts

    def launch(name, counts, *rays, own=None):
        work, records = ct._launch_work(own, o.device)
        if own is not None:
            assert work is own and records is None
            return
        work += torch.tensor(counts)
        ct._record_work(records, name, work, (b, t, b, t), o, d, *rays)

    def frame(r, n, plain):
        launch("cluster_closest_walk_baked", [8, 64, 32, 64], key0, key0)
        launch("cluster_closest_walk", [8, 64, 32, 64], key0, key0)
        launch("cluster_closest_walk", [8, 64, 32, 64], key0, key0, own=torch.zeros(4, dtype=torch.int64))
        launch("cluster_any_walk", [6, 0, 32, 0], t_max, torch.zeros(4, dtype=torch.bool))
        launch("cluster_any_walk", [6, 0, 32, 0], t_max, torch.zeros(4, dtype=torch.bool))

    monkeypatch.setattr(ct, "walk_bound_counts", lambda *a, **k: (3, 128))
    monkeypatch.setattr(profile_frames, "_eager_frames", frame)
    w = profile_frames.walk_work(None)
    assert launches.open_work_records() is None
    assert w["B3_baked"] == {"launches": 1, "rays": 4, "live_rays": 3, "slab_tests": 8 / 3, "tri_tests": 64 / 3,
                             "slab_lane_slots": 32 / 3, "test_lane_slots": 64 / 3, "bound_slab_tests": 1.0,
                             "bound_tri_tests": 128 / 3}
    assert w["B3_walk"]["launches"] == 1 and w["B3_walk"]["live_rays"] == 3
    assert w["B4_walk"]["launches"] == 2 and w["B4_walk"]["live_rays"] == 4
    assert w["B4_walk"]["slab_tests"] == pytest.approx(12 / 4) and w["B4_walk"]["bound_tri_tests"] == 256 / 4


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("the frame graph and its stage map exist only on a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
def test_a_captured_tetra_frame_names_the_cluster_stages(cuda):
    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    r = Renderer(parse_scene(os.path.join(COMMITTED, "scene.json")), width=1024, height=1024,
                 mode=RendererType.PATH, path_depth=4, device="cuda")
    assert r.bvh.clustered and r.bvh.num_tris == 4 ** 10 + 2
    r.render(2)  # the key's eager frame, then the capture and a replay
    stage_map = r.frame_stages()
    nested = {name for name, _first, _end in stage_map["nested"]}
    assert {"trace.sweep", "trace.sort", "trace.shade"} <= nested
    kernels = [k for _pos, k in stage_map["kernels"]]
    assert "closest_walk_kernel" in kernels and "any_walk_kernel" in kernels
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(2)
    b = profile_frames.stage_breakdown(*profile_frames.profiled_events(prof), 2, stage_map)
    assert b["unmapped_replays"] == 0
    # the sweep and the shading are hand kernels (K-sweep, stage S; K4), nine and five launches a frame inside
    # their spans
    assert "trace.sort" in b["glue_stages"] and {"trace.sweep", "trace.shade"} <= set(b["frame_stages"])
    assert b["stages"]["S"]["calls_per_frame"] == 9 and "supercluster_sweep_kernel" in kernels
    assert b["stages"]["K4"]["calls_per_frame"] == 5 and kernels.count("cluster_shade_kernel") == 5

