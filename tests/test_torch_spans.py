"""The port's own spans (``utils.launches.span``) and the stage map of a
captured frame graph (``utils.launches.stage_map``), on the CPU.

With no profiler open a span is a shared null context and opens no
profiler range; under a CPU profiler a PATH ``render`` shows its spans
nested as the renderer states them, each frame stage once a frame and
each bounce stage once a bounce, and no span takes a name of the
benchmark's phases; with a stand-in node counter and a stand-in capture,
``FrameGraph``'s bookkeeping gives a map that covers every node once, in
order, the innermost ``frame.*`` span winning, with the hand kernels at
the nodes their launches made.
"""

from __future__ import annotations

import os
import types

import pytest
import torch

from optix_renderer_tpu_torch.accel import brute_trace as bt
from optix_renderer_tpu_torch.engine import frame_graph as fg
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.integrators import path_kernel as pk
from optix_renderer_tpu_torch.scene import parse_scene
from optix_renderer_tpu_torch.utils import launches
from optix_renderer_tpu_torch.utils.launches import span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell", "scene.json")
DEPTH = 2
FRAMES = 2
# the benchmark's phase names (portbench/harness/trace.py), which no span of the program may take
PHASES = ("set_camera", "render", "readback")


@pytest.fixture(scope="module")
def cornell():
    return parse_scene(CORNELL)


def test_a_span_without_a_profiler_opens_no_range(cornell, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("frame.camera_rng") is span("renderer.render")  # one shared null context
    r = Renderer(cornell, width=8, height=8, mode=RendererType.PATH, path_depth=DEPTH, device="cpu")
    r.render(FRAMES)
    r.image()
    assert r.state.accum_id == FRAMES


def _tree(prof) -> list:
    """The program's spans as (name, parent name), in start order, from
    the profiler's user ranges (they nest on the one thread)."""
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


def test_the_spans_of_a_path_render_nest_as_stated(cornell):
    r = Renderer(cornell, width=16, height=16, mode=RendererType.PATH, path_depth=DEPTH, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.set_camera(cornell.cameras[0])
        r.render(FRAMES)
        r.image()
    tree = _tree(prof)
    count: dict = {}
    for name, _parent in tree:
        count[name] = count.get(name, 0) + 1
    parents = {name: {p for n, p in tree if n == name} for name in count}
    assert not set(count) & set(PHASES)
    assert all("." in name for name in count)  # every span has a dotted prefix
    assert parents["renderer.set_camera"] == {None} and parents["renderer.render"] == {None}
    assert parents["renderer.image"] == {None}
    assert parents["set_camera.basis"] == parents["set_camera.zero"] == {"renderer.set_camera"}
    assert parents["image.divide"] == parents["image.to_host"] == {"renderer.image"}
    for name in ("frame_graph.load", "frame_graph.eager", "frame_graph.clone"):
        assert parents[name] == {"renderer.render"}
    assert count["frame_graph.eager"] == FRAMES and count["frame_graph.load"] == count["frame_graph.clone"] == 1
    once = ("frame.camera_rng", "frame.primary_trace", "frame.path_init", "frame.finish", "frame.gbuffers",
            "frame.accumulate")
    bounce = ("frame.bounce.sample", "frame.bounce.shadow", "frame.bounce.trace", "frame.bounce.count",
              "frame.bounce.combine")
    for name in once:
        assert count[name] == FRAMES and parents[name] == {"frame_graph.eager"}, name
    for name in bounce:
        assert count[name] == FRAMES * DEPTH and parents[name] == {"frame_graph.eager"}, name
    assert {n for n in count if n.startswith("frame.")} == set(once) | set(bounce)
    # inside the stages: the shading after each closest trace, the plain bounce's pieces
    assert parents["trace.shade"] == {"frame.primary_trace", "frame.bounce.trace"}
    assert count["trace.shade"] == FRAMES * (1 + DEPTH)
    assert parents["bounce.nee"] == parents["bounce.bsdf"] == {"frame.bounce.sample"}
    frame = ["frame.camera_rng", "frame.primary_trace", "frame.path_init", *bounce * DEPTH, "frame.finish",
             "frame.gbuffers", "frame.accumulate"]
    assert [name for name, parent in tree if parent == "frame_graph.eager"] == frame * FRAMES


class _Graph:
    def replay(self):
        pass


class _Capture:
    def __init__(self, graph, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_capture_maps_every_node_once(monkeypatch):
    nodes = [0]  # the stand-in graph's executable nodes

    def make(n=1):
        nodes[0] += n

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(launches, "capture_node_counter", lambda: lambda: nodes[0])

    def step(buf, ds, bvh, **static):
        make(2)  # outside every frame stage: the capture's own
        with span("frame.camera_rng"):
            make(3)
        with span("frame.primary_trace"):
            with span("trace.shade"):  # a stage nested in the primary trace's: its nodes stay that stage's too
                make()
                launches.count_launch(bt.LAUNCHES, "brute_closest", "closest_kernel")
                make()
        for _ in range(2):
            with span("frame.bounce.sample"):
                make()
                launches.count_launch(pk.LAUNCHES, "path_sample", "path_sample_kernel")
            with span("frame.bounce.count"):
                pass  # no node: no entry
            with span("frame.bounce.combine"):
                with span("frame.finish"):  # an inner frame stage wins
                    make(2)
                make()
        with span("frame.accumulate"):
            make(4)
        with span("frame.accumulate"):  # adjacent: one entry
            make()
        make()
        return "gbuffers", "aux"

    monkeypatch.setattr(fg, "frames_step", step)
    bt.reset_launch_counts()
    pk.reset_launch_counts()
    buf = types.SimpleNamespace(accum=types.SimpleNamespace(device=torch.device("cuda", 0)))
    graph = fg.FrameGraph(("key",), buf, None, None)
    st = graph.stages
    assert st["nodes"] == nodes[0] == 21
    # contiguous, in order, covering [0, nodes) once
    ends = [0] + [end for _stage, _first, end in st["stages"]]
    assert [first for _stage, first, _end in st["stages"]] == ends[:-1] and ends[-1] == st["nodes"]
    assert all(first < end for _stage, first, end in st["stages"])
    assert [tuple(s) for s in st["stages"]] == [
        ("frame_graph.capture", 0, 2), ("frame.camera_rng", 2, 5), ("frame.primary_trace", 5, 7),
        ("frame.bounce.sample", 7, 8), ("frame.finish", 8, 10), ("frame.bounce.combine", 10, 11),
        ("frame.bounce.sample", 11, 12), ("frame.finish", 12, 14), ("frame.bounce.combine", 14, 15),
        ("frame.accumulate", 15, 20), ("frame_graph.capture", 20, 21)]
    assert [tuple(s) for s in st["nested"]] == [("trace.shade", 5, 7)]
    assert [tuple(k) for k in st["kernels"]] == [(5, "closest_kernel"), (7, "path_sample_kernel"),
                                                 (11, "path_sample_kernel")]
    # the capture counted no launch, and each replay counts what the tally recorded
    assert bt.LAUNCHES["brute_closest"] == 0 and pk.LAUNCHES["path_sample"] == 0
    graph.replay()
    assert bt.LAUNCHES["brute_closest"] == 1 and pk.LAUNCHES["path_sample"] == 2
    bt.reset_launch_counts()
    pk.reset_launch_counts()


def test_a_capture_without_a_node_counter_has_no_map(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(launches, "capture_node_counter", lambda: None)
    monkeypatch.setattr(fg, "frames_step", lambda buf, ds, bvh, **static: ("gbuffers", "aux"))
    buf = types.SimpleNamespace(accum=types.SimpleNamespace(device=torch.device("cuda", 0)))
    assert fg.FrameGraph(("key",), buf, None, None).stages is None


GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
B1 = "void (anonymous namespace)::closest_kernel<false>(float const*, int)"
COPY = "Memcpy DtoD (Device -> Device)"


def test_the_profile_maps_replays_by_position_and_eager_ops_by_span():
    """``profile_frames.stage_breakdown`` on hand-built events (ns): a
    replay maps when its count and its hand kernel's node agree with the
    stage map, an eager operation takes the innermost span around its
    launch, and the idle time inside ``renderer.render`` splits into the
    gaps between replays and the call's own."""
    from optix_renderer_tpu_torch.utils import profile_frames

    stage_map = {"nodes": 3, "stages": [["frame.camera_rng", 0, 1], ["frame.primary_trace", 1, 3]],
                 "kernels": [[1, "closest_kernel"]]}
    calls = {7: (50, "cudaMemcpyAsync", 1), 8: (60, "cudaGraphLaunch", 1), 9: (70, "cudaGraphLaunch", 1),
             10: (80, "cudaLaunchKernel", 1), 11: (90, "cudaGraphLaunch", 1)}
    spans = [(40, 170, "renderer.render", 1), (45, 55, "frame_graph.load", 1), (75, 85, "frame_graph.clone", 1),
             (78, 82, "trace.sort", 1)]
    ops = [(100, 1, COPY, 7),  # the load's copy
           (110, 1, GLUE, 8), (111, 1, B1, 8), (112, 1, GLUE, 8),  # replay 0: maps
           (120, 1, GLUE, 9), (121, 1, GLUE, 9), (122, 1, GLUE, 9),  # replay 1: no closest_kernel at node 1
           (130, 1, GLUE, 10),  # launched inside trace.sort inside the clone
           (140, 1, GLUE, 11), (141, 1, B1, 11), (142, 1, GLUE, 11),  # replay 2: maps
           (200, 1, COPY, 7)]  # after the call's end: its gap counts up to 170
    b = profile_frames.stage_breakdown(spans, calls, ops, 1, stage_map)
    assert b["unmapped_replays"] == 1 and b["kernels_per_frame"] == len(ops)
    assert b["frame_stages"] == pytest.approx({"frame_graph.load": 2e-6, "frame.camera_rng": 2e-6,
                                               "frame.primary_trace": 4e-6, "None": 3e-6, "trace.sort": 1e-6})
    assert b["glue_stages"] == pytest.approx({"frame_graph.load": 2e-6, "frame.camera_rng": 2e-6,
                                              "frame.primary_trace": 2e-6, "None": 3e-6, "trace.sort": 1e-6})
    assert b["stages"]["B1"]["calls_per_frame"] == 2 and b["stages"]["sort"]["device_ms_per_frame"] == 1e-6
    # idle: 101-110 eager -> replay 0 (the call's), 113-120 replay 0 -> 1, 123-130 replay 1 -> eager,
    # 131-140 eager -> replay 2, 143-170 after the last replay up to the call's end
    assert b["replay_gap_ms_per_frame"] == pytest.approx(7e-6)
    assert b["call_gap_ms_per_frame"] == pytest.approx((9 + 7 + 9 + 27) * 1e-6)
    bare = profile_frames.stage_breakdown(spans, calls, ops, 1, None)  # no stage map: no replay maps
    assert bare["unmapped_replays"] == 3 and bare["replay_gap_ms_per_frame"] == b["replay_gap_ms_per_frame"]


def test_a_profiled_render_on_the_card_maps_every_replayed_op():
    """On a CUDA card: a profiled ``render(4)`` of the Cornell box in PATH
    depth 4 at 1024^2 maps every operation of its four replays to a stage
    of the frame graph's map."""
    if not torch.cuda.is_available():
        pytest.skip("the frame graph's stage map exists only on a CUDA card")
    from optix_renderer_tpu_torch.utils import profile_frames

    scene = parse_scene(CORNELL)
    r = Renderer(scene, width=1024, height=1024, mode=RendererType.PATH, path_depth=4, device="cuda")
    r.render(2)  # the key's eager frame, then the capture and a replay
    stage_map = r.frame_stages()
    assert stage_map["nodes"] > 0
    assert [k for _pos, k in stage_map["kernels"]].count("path_sample_kernel") == 4
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(4)
    spans, calls, ops = profile_frames.profiled_events(prof)
    replayed = [op for op in ops if op[3] in calls and "GraphLaunch" in calls[op[3]][1]]
    assert len(replayed) == 4 * stage_map["nodes"]
    b = profile_frames.stage_breakdown(spans, calls, ops, 4, stage_map)
    assert b["unmapped_replays"] == 0
    assert sum(1 for s in spans if s[2] == "frame_graph.replay") == 4
    assert b["replay_gap_ms_per_frame"] >= 0 and b["call_gap_ms_per_frame"] >= 0
