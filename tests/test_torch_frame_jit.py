"""One dispatch for every frame (``engine/frame_graph.py::FrameSlot``), the
port's counterpart of the JAX ``_frame_jit``, on the CPU.

Every Renderer frame, detached frame and split tile runs through a frame
slot: on a card its key's first frame eagerly, then replays of one captured
graph.  Here the graph is a stand-in (``engine.frame_graph._graphs`` forced
true, ``FrameGraph`` replaced by a class that runs ``frames_step`` eagerly
and copies its outputs into the first replay's, as a graph's static
outputs), and the table is baked on the CPU where it matters.  Held, at
32^2 on the procedural Cornell box and the grid-60 terrain:

* ``render(n)`` bit for bit against n ``_frame_impl`` frames in PATH,
  RATIO, LTC_BASELINE, NORMALS and DIFFUSE: state, g-buffers, aux and
  ``metrics`` (honest rays, ``alive_per_bounce``);
* ``render(4)`` against the JAX ``render(4)``: relative RMSE as
  ``tests/goldens/test_goldens.py::_check``, 5e-3 for PATH and 1e-4 for
  LTC_BASELINE;
* a deterministic mode renders one replay per accumulation;
* a rebaking ``set_camera`` keeps the graph, and the next frames equal
  eager frames from the new camera and table; ``set_mode`` drops it;
* ``render_step_detached`` returns clones: a later replay leaves a frame
  returned earlier as it was, and dropping a frame leaves the renderer as
  it was;
* the row split and the spp split through per-tile stand-in graphs, bit
  for bit against one device;
* a Renderer keeps one set of graphs: ``render`` after the row split drops
  the tiles' graphs, and the row split after ``render`` the whole frame's;
* interleaving (``render(3)``, a detached frame, ``commit_step``, a
  rebaking ``set_camera``, ``render(3)``) bit-equal to the same frames run
  eagerly;
* two threads on one Renderer take turns on its buffers: no two frames
  overlap, and every frame equals the eager frame of its snapshot.
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.modes import RendererType as JRendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine import frame_graph as fg
from optix_renderer_tpu_torch.engine import renderer as renderer_mod
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.parallel import sharding
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene, write_terrain_scene
from optix_renderer_tpu_torch.scene.config import SceneCamera

torch.set_num_threads(2)

RES, DEPTH = 32, 2
GB_FIELDS = ("position", "normal", "albedo", "alpha", "uv", "material_id")
DEADLINE = 120.0


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("frame_jit")
    return {"cornell": write_cornell_scene(str(d / "cornell")),
            "terrain": write_terrain_scene(str(d / "terrain"), grid=60, width=RES, height=RES)}


class _StandInGraph:
    """Takes FrameGraph's place: replays by calling frames_step eagerly and
    copying its outputs into the first replay's, as a graph's static
    outputs are rewritten by every replay."""

    made = []

    def __init__(self, key, buf, ds, bvh, **static):
        self.key, self.replays, self.outputs = key, 0, None
        self._args, self._static = (buf, ds, bvh), static
        _StandInGraph.made.append(self)

    def replay(self):
        self.replays += 1
        gb, aux = fg.frames_step(*self._args, **self._static)
        if self.outputs is None:
            self.outputs = (gb, aux)
        else:
            for f in GB_FIELDS:
                getattr(self.outputs[0], f).copy_(getattr(gb, f))
            for k, v in aux.items():
                self.outputs[1][k].copy_(v)
        return self.outputs


@pytest.fixture
def graphed(monkeypatch):
    """Frames replay stand-in graphs on the CPU, and the cluster tier bakes there."""
    _StandInGraph.made = []
    monkeypatch.setattr(fg, "_graphs", lambda device: True)
    monkeypatch.setattr(fg, "FrameGraph", _StandInGraph)
    monkeypatch.setattr(renderer_mod, "_bakes", lambda bvh: bvh.clustered)
    return _StandInGraph.made


def _renderer(paths, name, mode, **kw):
    return Renderer(parse_scene(paths[name]), width=RES, height=RES, mode=mode, path_depth=DEPTH, device="cpu", **kw)


def _eager(r: Renderer, state, n: int):
    """n ``_frame_impl`` frames from ``state`` with r's table: (state, each frame's (gbuffers, aux))."""
    frames = []
    for _ in range(n):
        state, gb, aux = _frame_impl(state, r.device_scene, r.bvh, mode=r.mode, width=r.width, height=r.height,
                                     path_depth=r.path_depth, ratio_samples=r.ratio_samples, baked_tab=r.baked_tab)
        frames.append((gb, aux))
    return state, frames


def _assert_gbuffers_equal(got, want) -> None:
    for f in GB_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _assert_frames_equal(r: Renderer, want_state, frames) -> None:
    """r's published state, g-buffers and aux are what ``frames`` (eager, from one state) give."""
    assert r.state.accum_id == want_state.accum_id and torch.equal(r.state.accum, want_state.accum)
    _assert_gbuffers_equal(r.gbuffers, frames[-1][0])
    auxes = [aux for _gb, aux in frames]
    if r.mode == RendererType.RATIO:  # the mean over the call's frames, summed in frame order
        for k in auxes[0]:
            total = auxes[0][k]
            for a in auxes[1:]:
                total = total + a[k]
            assert torch.equal(r.aux[k], total / len(auxes)), k
    elif r.mode == RendererType.PATH:
        assert torch.equal(r.aux["path_alive_counts"], auxes[-1]["path_alive_counts"])
    else:
        assert r.aux == {}


def _eager_metrics(r: Renderer, frames) -> dict:
    """The ``metrics`` a call rendering ``frames`` adds: frames and honest rays."""
    rays = len(frames) * r.width * r.height * (1 + (r.ratio_samples if r.mode == RendererType.RATIO else 0))
    alive = [aux["path_alive_counts"] for _gb, aux in frames if "path_alive_counts" in aux]
    rays += sum(int(a[:, 1:].sum()) for a in alive)
    out = {"frames": len(frames), "rays_traced": rays}
    if alive:
        out["alive_per_bounce"] = [int(x) for x in alive[-1][:, 0]]
    return out


def _moved(cam: SceneCamera) -> SceneCamera:
    return SceneCamera(from_=np.asarray(cam.from_, np.float32) + np.float32([3.0, -2.0, 5.0]), at=cam.at,
                       up=cam.up, cos_fovy=cam.cos_fovy)


# ---------------------------------------------------------------------------
# render(n) through the graph against n _frame_impl frames, and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode", [("cornell", RendererType.PATH), ("cornell", RendererType.RATIO),
                                       ("cornell", RendererType.LTC_BASELINE), ("cornell", RendererType.DIFFUSE),
                                       ("terrain", RendererType.NORMALS), ("terrain", RendererType.PATH)],
                         ids=["path", "ratio", "ltc", "diffuse", "terrain-normals", "terrain-path"])
def test_render_n_matches_frame_impl(paths, graphed, name, mode):
    r = _renderer(paths, name, mode)
    assert (r.baked_tab is not None) == (name == "terrain")
    n = 1 if mode in (RendererType.LTC_BASELINE, RendererType.DIFFUSE, RendererType.NORMALS) else 3
    start = r.state
    want, frames = _eager(r, start, n)
    r.render(3)  # the key's eager frame, then the capture and replays
    _assert_frames_equal(r, want, frames)
    assert len(graphed) == (n > 1) and (n == 1 or graphed[0].replays == n - 1)
    m = dict(r.metrics)
    for k, v in _eager_metrics(r, frames).items():
        assert m[k] == v, k
    assert start.accum_id == 0 and float(start.accum.abs().sum()) == 0.0  # the start state as it was
    if n > 1:  # a second call: replays only, its own frames and metrics
        want2, frames2 = _eager(r, r.state, n)
        r.render(n)
        _assert_frames_equal(r, want2, frames2)
        assert len(graphed) == 1 and graphed[0].replays == 2 * n - 1
        m2 = _eager_metrics(r, frames2)
        assert r.metrics["rays_traced"] == m["rays_traced"] + m2["rays_traced"]
        assert r.metrics["alive_per_bounce"] == m2.get("alive_per_bounce", [])


@pytest.mark.parametrize("mode,tol", [(RendererType.PATH, 5e-3), (RendererType.LTC_BASELINE, 1e-4)],
                         ids=["path", "ltc"])
def test_render_four_matches_jax(paths, graphed, mode, tol):
    jr = JRenderer(jparse_scene(paths["cornell"]), width=RES, height=RES, mode=JRendererType(int(mode)),
                   path_depth=DEPTH)
    jr.render(4)
    r = _renderer(paths, "cornell", mode)
    r.render(4)
    assert r.state.accum_id == int(jr.state.accum_id) == (4 if mode == RendererType.PATH else 1)
    want, got = np.asarray(jr.image()), r.image()
    assert got.shape == want.shape and np.abs(want).mean() > 0
    rmse = float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)
    assert rmse < tol, rmse
    if mode == RendererType.PATH:
        assert len(graphed) == 1 and graphed[0].replays == 3


def test_deterministic_mode_renders_one_replay_per_accumulation(paths, graphed):
    r = _renderer(paths, "cornell", RendererType.LTC_BASELINE)
    r.render(1)  # the key's eager frame
    assert not graphed and r.state.accum_id == 1
    r.render(3)  # converged: nothing runs
    assert not graphed and r.state.accum_id == 1
    for k in range(3):
        r.set_camera(r.scene.cameras[0])
        want, frames = _eager(r, r.state, 1)
        r.render(2)
        assert len(graphed) == 1 and graphed[0].replays == k + 1
        _assert_frames_equal(r, want, frames)
    assert r.metrics["frames"] == 4


# ---------------------------------------------------------------------------
# what keeps and what drops the graph
# ---------------------------------------------------------------------------

def test_rebaking_set_camera_keeps_the_graph(paths, graphed):
    r = _renderer(paths, "terrain", RendererType.PATH)
    r.render(2)
    graph, key, table0 = r._frames.slots[0].graph, r._frames.slots[0].key, r.baked_tab
    assert graph is graphed[0]
    r.set_camera(_moved(r.scene.cameras[0]))
    assert r.baked_tab is not table0 and not np.array_equal(r.baked_tab.origin, table0.origin)  # rebaked
    assert r._frames.slots[0].key == key and r._frames.slots[0].graph is graph
    want, frames = _eager(r, r.state, 2)
    r.render(2)
    _assert_frames_equal(r, want, frames)
    assert len(graphed) == 1 and graph.replays == 3


def test_set_mode_drops_the_graph(paths, graphed):
    r = _renderer(paths, "cornell", RendererType.PATH)
    r.render(2)
    first = r._frames.slots[0].graph
    r.set_mode(RendererType.PATH)  # the same mode: nothing changes
    assert r._frames.slots[0].graph is first
    r.set_mode(RendererType.RATIO)
    assert r._frames is None
    r.render(2)  # a new key: its eager frame, then a capture
    assert len(graphed) == 2 and r._frames.slots[0].graph is graphed[1] is not first
    assert graphed[1].key[0][0] == RendererType.RATIO


# ---------------------------------------------------------------------------
# detached frames, the split and interleaving
# ---------------------------------------------------------------------------

def test_render_step_detached_returns_clones(paths, graphed):
    r = _renderer(paths, "cornell", RendererType.RATIO)
    r.render(2)
    state0, gb0, aux0 = r.state, r.gbuffers, r.aux
    snapshot = (state0.accum.clone(), {f: getattr(gb0, f).clone() for f in GB_FIELDS},
                {k: v.clone() for k, v in aux0.items()})
    metrics0 = {k: (list(v) if isinstance(v, list) else v) for k, v in r.metrics.items()}
    want, frames = _eager(r, state0, 1)
    first = r.render_step_detached()
    kept = (first[0].accum.clone(), {f: getattr(first[1], f).clone() for f in GB_FIELDS},
            {k: v.clone() for k, v in first[2].items()})
    assert first[0].accum_id == 3 and torch.equal(first[0].accum, want.accum)
    _assert_gbuffers_equal(first[1], frames[0][0])
    for k, v in frames[0][1].items():
        assert torch.equal(first[2][k], v), k
    r.set_camera(_moved(r.scene.cameras[0]))  # another state: a later replay writes other values
    second = r.render_step_detached()
    assert not torch.equal(second[0].accum, first[0].accum)
    assert torch.equal(first[0].accum, kept[0])  # the frame returned earlier is as it was
    for f in GB_FIELDS:
        assert torch.equal(getattr(first[1], f), kept[1][f]), f
    for k in kept[2]:
        assert torch.equal(first[2][k], kept[2][k]), k
    # both frames dropped: the renderer was left as it was at the set_camera
    r.set_camera(r.scene.cameras[0])
    assert r.gbuffers is gb0 and r.aux is aux0
    assert torch.equal(state0.accum, snapshot[0]) and state0.accum_id == 2
    for f in GB_FIELDS:
        assert torch.equal(getattr(gb0, f), snapshot[1][f]), f
    for k in snapshot[2]:
        assert torch.equal(aux0[k], snapshot[2][k]), k
    assert r.metrics == metrics0 and len(graphed) == 1


def test_row_split_through_tile_graphs_is_bit_identical(paths, graphed):
    r = _renderer(paths, "terrain", RendererType.PATH)
    one = _renderer(paths, "terrain", RendererType.PATH)
    cpus = ["cpu"] * 4
    for n in (2, 3):  # the tiles' eager frames, then captures and replays; then replays only
        want, frames = _eager(one, r.state, n)
        sharding.render_rows(r, cpus, n)
        _assert_frames_equal(r, want, frames)
        assert r.metrics["alive_per_bounce"] == _eager_metrics(r, frames)["alive_per_bounce"]
    assert len(graphed) == 4 and [g.replays for g in graphed] == [4] * 4
    assert sorted(g.key[2] for g in graphed) == [0, 8, 16, 24]  # one graph per row range
    r.set_camera(_moved(r.scene.cameras[0]))  # every tile takes the new table
    want, frames = _eager(r, r.state, 1)
    sharding.render_rows(r, cpus, 1)
    _assert_frames_equal(r, want, frames)
    assert len(graphed) == 4 and [g.replays for g in graphed] == [5] * 4


def test_a_renderer_keeps_one_set_of_graphs(paths, graphed):
    r = _renderer(paths, "cornell", RendererType.PATH)
    refs = []

    def alive():  # the graphs made so far that something still holds (the stand-in's list lets go of them)
        refs.extend(weakref.ref(g) for g in graphed)
        graphed.clear()
        gc.collect()
        return [g for g in (w() for w in refs) if g is not None]

    for run, n_graphs in ((lambda: r.render(3), 1), (lambda: sharding.render_rows(r, ["cpu"] * 2, 3), 2),
                          (lambda: r.render(3), 1)):
        want, frames = _eager(r, r.state, 3)
        run()
        _assert_frames_equal(r, want, frames)
        live = alive()
        assert len(live) == n_graphs and all(g is s.graph for g, s in zip(live, r._frames.slots))
        del live
    assert len(refs) == 4 and r.state.accum_id == 9


def test_spp_split_through_graphs_matches_sequential_frames(paths, graphed):
    r = _renderer(paths, "cornell", RendererType.PATH)
    cpus = ["cpu"] * 3
    step = sharding.make_spp_sharded_frame_fn(cpus, RendererType.PATH, RES, RES, path_depth=DEPTH)
    reps = [sharding.replicate(x, cpus) for x in (r.device_scene, r.bvh, r.baked_tab)]
    state = r.state
    for k in range(3):  # each device's eager frame, then a capture and a replay, then replays
        got, gbs, auxs = step(state, *reps)
        want, frames = _eager(r, state, 3)
        assert got.accum_id == want.accum_id and torch.equal(got.accum, want.accum)
        for (gb, aux), g, a in zip(frames, gbs, auxs):
            _assert_gbuffers_equal(g, gb)
            assert torch.equal(a["path_alive_counts"], aux["path_alive_counts"])
        state = got
        assert len(graphed) == (0 if k == 0 else 3)
    assert [g.replays for g in graphed] == [2] * 3


def test_interleaving_matches_eager_frames(paths, graphed):
    r = _renderer(paths, "terrain", RendererType.PATH)
    want, frames = _eager(r, r.state, 3)
    r.render(3)
    _assert_frames_equal(r, want, frames)
    want, frames = _eager(r, r.state, 1)
    frame = r.render_step_detached()
    r.commit_step(*frame, 0.0)
    _assert_frames_equal(r, want, frames)
    assert r.metrics["frames"] == 4 and r.metrics["alive_per_bounce"] == _eager_metrics(r, frames)["alive_per_bounce"]
    r.set_camera(_moved(r.scene.cameras[0]))
    want, frames = _eager(r, r.state, 3)
    r.render(3)
    _assert_frames_equal(r, want, frames)
    assert len(graphed) == 1 and graphed[0].replays == 2 + 1 + 3


def test_two_threads_take_turns_on_the_buffers(paths, graphed, monkeypatch):
    r = _renderer(paths, "cornell", RendererType.PATH)
    r.render(1)
    want, frames = _eager(r, r.state, 1)
    inside, overlaps = [0], []
    step = fg.frames_step
    gate = threading.Lock()

    def exclusive(*args, **kwargs):  # a frame that notices another frame on the same buffers
        with gate:
            inside[0] += 1
            overlaps.append(inside[0] > 1)
        try:
            return step(*args, **kwargs)
        finally:
            with gate:
                inside[0] -= 1

    monkeypatch.setattr(fg, "frames_step", exclusive)
    results, errors = [], []
    interval = sys.getswitchinterval()

    def worker():
        try:
            for _ in range(4):
                results.append(r.render_step_detached())
        except Exception as e:  # the thread's boundary: the test reads it
            errors.append(e)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 8 and len(overlaps) == 8 and not any(overlaps)
    for state, gb, aux in results:
        assert state.accum_id == 2 and torch.equal(state.accum, want.accum)
        _assert_gbuffers_equal(gb, frames[0][0])
        assert torch.equal(aux["path_alive_counts"], frames[0][1]["path_alive_counts"])
    assert r.state.accum_id == 1  # nothing committed
