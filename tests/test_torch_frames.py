"""Several frames in one dispatch (``engine/frame_graph.py``), the port's
counterpart of the JAX ``_frames_scan_impl``, on the CPU.

* ``make_rng`` with the frame id as a 0-d tensor: bit-equal to the int form
  and to the JAX ``core/rng.make_rng``;
* n eager ``frames_step`` calls: bit-equal to n ``_frame_impl`` frames in
  PATH and RATIO (accumulator, RATIO's sums, PATH's per-bounce counts, the
  last frame's own g-buffers and aux), on Cornell and the
  three-light Cornell;
* ``Renderer.render(4)`` of the port against the JAX ``Renderer.render(4)``,
  which takes ``_frames_scan_jit`` (the port's versions of JAX's
  ``test_multiframe_scan_matches_stepwise`` and of the RATIO scan test):
  relative RMSE as ``tests/goldens/test_goldens.py::_check``, 5e-3 for the
  path image and 1e-4 for RATIO's image and ``ltc`` (the same deterministic
  f32 LTC arithmetic); RATIO's ``sto_direct`` and ``sto_no_vis`` 5e-3, as
  ``tests/test_torch_ratio.py`` holds them (a last-bit difference in a light
  sample's direction can flip its shadow ray);
* ``render(4)`` bit-equal to 4 x ``render(1)`` with equal ``metrics``; the
  input state left as it was;
* the Renderer's graph, through a stand-in ``FrameGraph`` on the CPU:
  captured once after an eager frame, kept by a rebaking ``set_camera`` or
  ``load_checkpoint`` (the buffers take the new table), dropped when
  ``set_mode`` changes its key, and a failing capture raising;
* ``FrameGraph`` itself, against a stand-in ``torch.cuda`` graph: the
  capture's launches counted on every replay and not for the capture, the
  capture's outputs returned by every replay; CPU buffers refused without
  touching CUDA.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu_torch.accel import brute_trace as bt
from optix_renderer_tpu_torch.accel import cluster_trace as ct
from optix_renderer_tpu_torch.core import rng as trng
from optix_renderer_tpu_torch.engine import frame_graph as fg
from optix_renderer_tpu_torch.engine import renderer as renderer_mod
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.scene.config import SceneCamera
from optix_renderer_tpu_torch.shading import ltc_kernel as lk
from optix_renderer_tpu_torch.utils import launches

torch.set_num_threads(2)

RES = 32
DEPTH = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STO = ("sto_direct", "sto_no_vis")


def _rel_rmse(got, want) -> float:
    """Relative RMSE, as tests/goldens/test_goldens.py::_check."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames_scenes")
    return {"cornell": parse_scene(procedural.write_cornell_scene(str(d / "c"))),
            "cornell3": parse_scene(procedural.write_cornell3_scene(str(d / "c3")))}


def _renderer(scenes, name, mode, res=RES):
    return Renderer(scenes[name], width=res, height=res, mode=mode, path_depth=DEPTH, device="cpu")


# ---------------------------------------------------------------------------
# the RNG's frame id as a device scalar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame_id", [0, 1, 10007, 10010, 2**31 - 1, 2**32 - 1])
def test_make_rng_tensor_frame_id_bit_exact(frame_id):
    ids = np.random.default_rng(frame_id % 97).integers(0, 2**32, size=4096, dtype=np.uint64)
    lin = torch.as_tensor(ids.astype(np.int64))
    want = trng.make_rng(frame_id, lin)
    got = trng.make_rng(torch.tensor(frame_id, dtype=torch.int64), lin)
    assert got.dtype == torch.int64 and got.shape == lin.shape
    assert torch.equal(got, want)
    jax_states = np.asarray(jrng.make_rng(jnp.uint32(frame_id), jnp.asarray(ids.astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), jax_states)


# ---------------------------------------------------------------------------
# frames_step against _frame_impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene_name,mode", [("cornell", RendererType.PATH), ("cornell3", RendererType.PATH),
                                             ("cornell", RendererType.RATIO), ("cornell3", RendererType.RATIO)])
def test_frames_step_matches_frame_impl(scenes, scene_name, mode):
    r = _renderer(scenes, scene_name, mode)
    kw = dict(mode=r.mode, width=r.width, height=r.height, path_depth=r.path_depth,
              ratio_samples=r.ratio_samples)
    n = 3
    state, frames = r.state, []
    for _ in range(n):
        state, gb, aux = _frame_impl(state, r.device_scene, r.bvh, **kw)
        frames.append(aux)

    buf = fg.FrameBuffers.for_frames(r.mode, r.width, r.height, r.path_depth, r.device)
    buf.load(r.state)
    for _ in range(n):
        got_gb, got_aux = fg.frames_step(buf, r.device_scene, r.bvh, **kw)
    assert int(buf.frame_id) == n
    assert torch.equal(buf.accum, state.accum)
    for f in ("position", "normal", "albedo", "alpha", "uv", "material_id"):  # the last frame's own outputs
        assert torch.equal(getattr(got_gb, f), getattr(gb, f)), f
    assert sorted(buf.sums) == sorted(frames[0]) == sorted(got_aux)
    for k, total in buf.sums.items():  # the n frames' sum, in frame order
        assert total.dtype == frames[0][k].dtype
        assert torch.equal(total, (frames[0][k] + frames[1][k]) + frames[2][k]), k
        assert torch.equal(got_aux[k], frames[2][k]), k
    assert r.state.accum_id == 0 and float(r.state.accum.abs().sum()) == 0.0  # load() copied, left it


def test_frame_buffers_load_resets_the_sums(scenes):
    r = _renderer(scenes, "cornell", RendererType.RATIO, res=16)
    buf = fg.FrameBuffers.for_frames(r.mode, 16, 16, r.path_depth, r.device)
    kw = dict(mode=r.mode, width=16, height=16, path_depth=r.path_depth, ratio_samples=r.ratio_samples)
    buf.load(r.state)
    fg.frames_step(buf, r.device_scene, r.bvh, **kw)
    assert int(buf.frame_id) == 1 and all(float(t.abs().sum()) > 0 for t in buf.sums.values())
    r.render(2)
    buf.load(r.state)
    assert int(buf.frame_id) == 2 and torch.equal(buf.accum, r.state.accum)
    assert all(float(t.abs().sum()) == 0 for t in buf.sums.values())
    for name in ("pos", "dir_00", "dir_du", "dir_dv"):
        assert torch.equal(getattr(buf.camera, name), getattr(r.state.camera, name))
        assert getattr(buf.camera, name) is not getattr(r.state.camera, name)
    with pytest.raises(ValueError, match="without a baked primary table"):
        buf.load(r.state, types.SimpleNamespace(tab=None, origin=np.zeros(3, np.float32)))


# ---------------------------------------------------------------------------
# Renderer.render(n): against JAX, against n render(1), purity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_four(scenes):
    """The JAX Renderer's render(4) (3 frames in _frames_scan_jit, then one):
    PATH depth 3 on Cornell and RATIO on the three-light Cornell, at 32^2."""
    p = JRenderer(scenes["cornell"], width=RES, height=RES, mode=RendererType.PATH, path_depth=DEPTH)
    p.render(4)
    q = JRenderer(scenes["cornell3"], width=RES, height=RES, mode=RendererType.RATIO)
    q.render(4)
    assert int(p.state.accum_id) == int(q.state.accum_id) == 4
    return {RendererType.PATH: (p.image(), {}, p.metrics["rays_traced"]),
            RendererType.RATIO: (q.image(), {k: np.asarray(v) for k, v in q.aux.items()}, q.metrics["rays_traced"])}


@pytest.mark.parametrize("mode", [RendererType.PATH, RendererType.RATIO])
def test_render_four_matches_jax_scan(scenes, jax_four, mode):
    want_img, want_aux, want_rays = jax_four[mode]
    r = _renderer(scenes, "cornell" if mode == RendererType.PATH else "cornell3", mode)
    r.render(4)
    assert r.state.accum_id == 4
    if mode == RendererType.PATH:
        assert _rel_rmse(r.image(), want_img) < 5e-3
    else:
        assert _rel_rmse(r.image(), want_img) < 1e-4
        assert _rel_rmse(r.aux["ltc"].numpy(), want_aux["ltc"]) < 1e-4
        for k in STO:
            err = _rel_rmse(r.aux[k].numpy(), want_aux[k])
            assert err < 5e-3, f"{k}: relative RMSE {err:.3g}"
        # the honest count is exact: every pixel's primary and shadow rays
        assert r.metrics["rays_traced"] == want_rays


@pytest.mark.parametrize("scene_name,mode", [("cornell", RendererType.PATH), ("cornell3", RendererType.RATIO)])
def test_render_n_matches_n_single_frames(scenes, scene_name, mode):
    a = _renderer(scenes, scene_name, mode)
    b = _renderer(scenes, scene_name, mode)
    start = a.state
    start_accum = start.accum.clone()
    a.render(4)
    singles = []
    for _ in range(4):
        b.render(1)
        singles.append(b.aux)
    assert a.state.accum_id == b.state.accum_id == 4
    assert torch.equal(a.state.accum, b.state.accum)
    if mode == RendererType.RATIO:
        for k in singles[0]:
            mean = (((singles[0][k] + singles[1][k]) + singles[2][k]) + singles[3][k]) / 4
            assert torch.equal(a.aux[k], mean), k
    else:
        assert torch.equal(a.aux["path_alive_counts"], b.aux["path_alive_counts"])  # the last frame's
    ma, mb = a.metrics, b.metrics
    for k in ("frames", "rays_traced", "alive_per_bounce"):
        assert ma[k] == mb[k], k
    assert ma["frames"] == 4
    # the state render(4) started from is left as it was
    assert start.accum is not a.state.accum and start.accum_id == 0 and torch.equal(start.accum, start_accum)


# ---------------------------------------------------------------------------
# the Renderer's graph, through a stand-in FrameGraph on the CPU
# ---------------------------------------------------------------------------

class _StandInGraph:
    """Takes FrameGraph's place: records its capture, replays by calling
    frames_step eagerly on the buffers and copying its outputs into the
    first replay's, as a graph's static outputs."""

    made = []

    def __init__(self, key, buf, ds, bvh, **static):
        self.key, self.replays, self.outputs = key, 0, None
        self._args = (buf, ds, bvh)
        self._static = static
        _StandInGraph.made.append(self)

    def replay(self):
        self.replays += 1
        gb, aux = fg.frames_step(*self._args, **self._static)
        if self.outputs is None:
            self.outputs = (gb, aux)
        else:
            for f in ("position", "normal", "albedo", "alpha", "uv", "material_id"):
                getattr(self.outputs[0], f).copy_(getattr(gb, f))
            for k, v in aux.items():
                self.outputs[1][k].copy_(v)
        return self.outputs


@pytest.fixture
def graphed(monkeypatch):
    """Renderers replay stand-in graphs on the CPU, and bake there too."""
    _StandInGraph.made = []
    monkeypatch.setattr(fg, "_graphs", lambda device: True)
    monkeypatch.setattr(fg, "FrameGraph", _StandInGraph)
    monkeypatch.setattr(renderer_mod, "_bakes", lambda bvh: bvh.clustered)
    return _StandInGraph.made


def test_graph_captured_after_an_eager_frame(scenes, graphed):
    r = _renderer(scenes, "cornell", RendererType.PATH, res=8)
    ref = _renderer(scenes, "cornell", RendererType.PATH, res=8)
    r.render(4)  # one eager frame (nothing of this key has run), the capture, 3 replays
    assert len(graphed) == 1 and graphed[0].replays == 3
    r.render(3)  # the same graph: 3 replays
    assert len(graphed) == 1 and graphed[0].replays == 6
    for _ in range(7):
        ref.render(1)
    assert torch.equal(r.state.accum, ref.state.accum) and r.state.accum_id == 7
    assert r.metrics["rays_traced"] == ref.metrics["rays_traced"]
    w = _renderer(scenes, "cornell", RendererType.PATH, res=8)
    w.render(1)  # the key's eager frame: the next call captures at once
    assert len(graphed) == 2 and w._frames.slots[0].graph is None
    w.render(3)
    assert len(graphed) == 3 and w._frames.slots[0].graph is graphed[2] and graphed[2].replays == 3


def _moved(cam: SceneCamera) -> SceneCamera:
    return SceneCamera(from_=np.asarray(cam.from_, np.float32) + np.float32([3.0, -2.0, 5.0]), at=cam.at,
                       up=cam.up, cos_fovy=cam.cos_fovy)


def test_graph_dropped_when_its_key_changes(graphed, tmp_path):
    gallery = parse_scene(os.path.join(REPO, "scenes", "gallery", "scene.json"))
    r = Renderer(gallery, width=8, height=8, mode=RendererType.PATH, path_depth=2, device="cpu")
    assert r.baked_tab is not None  # the cluster tier, baked (forced on the CPU)

    def captured():
        r.render(3)
        assert r._frames is not None and r._frames.slots[0].graph is graphed[-1]
        return graphed[-1]

    first = captured()
    r.set_camera(r.scene.cameras[0])  # the same origin: the table and the graph stay
    assert r._frames.slots[0].graph is first
    r.render(3)
    assert len(graphed) == 1 and first.replays == 5  # 2 after the eager frame and the capture, then 3
    r.save_checkpoint(str(tmp_path / "here.npz"))
    r.set_camera(_moved(r.scene.cameras[0]))  # rebakes: another table, the same key
    buf = r._frames.slots[0].buf
    assert r._frames.slots[0].graph is first and not np.array_equal(buf.baked.origin, r.baked_tab.origin)
    r.render(1)  # the buffers take the new table
    assert np.array_equal(buf.baked.origin, r.baked_tab.origin)
    assert torch.equal(buf.baked.tab, r.baked_tab.tab)
    r.load_checkpoint(str(tmp_path / "here.npz"))  # back at camera 0's origin: rebaked again, the same key
    r.render(1)
    assert r._frames.slots[0].graph is first and first.replays == 7
    r.set_mode(RendererType.RATIO)  # another mode
    assert r._frames is None
    r.set_mode(RendererType.PATH)
    second = captured()
    assert second is not first and len(graphed) == 2


def test_failing_capture_raises(scenes, monkeypatch):
    class Failing(_StandInGraph):
        def __init__(self, *args, **kwargs):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(fg, "_graphs", lambda device: True)
    monkeypatch.setattr(fg, "FrameGraph", Failing)
    r = _renderer(scenes, "cornell", RendererType.PATH, res=8)
    r.render(1)
    with pytest.raises(RuntimeError, match="capturing"):
        r.render(3)
    assert r.state.accum_id == 1  # no frame of the failed call was published


# ---------------------------------------------------------------------------
# FrameGraph and the launch counts
# ---------------------------------------------------------------------------

class _StubCudaGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StubCapture:
    def __init__(self, graph, **kwargs):
        self.graph = graph

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_replays_count_the_captured_launches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubCudaGraph)
    monkeypatch.setattr(torch.cuda, "graph", _StubCapture)

    def step(buf, ds, bvh, **static):  # what a PATH frame of depth 2 on the brute tier launches
        for _ in range(3):
            launches.count_launch(bt.LAUNCHES, "brute_closest")
        for _ in range(2):
            launches.count_launch(bt.LAUNCHES, "brute_any")
        launches.count_launch(lk.LAUNCHES, "ltc")
        return "gbuffers", "aux"

    monkeypatch.setattr(fg, "frames_step", step)
    for mod in (bt, ct, lk):
        mod.reset_launch_counts()
    buf = types.SimpleNamespace(accum=types.SimpleNamespace(device=torch.device("cuda", 0)))
    graph = fg.FrameGraph(("key",), buf, None, None)
    assert bt.LAUNCHES == {"brute_closest": 0, "brute_any": 0} and lk.LAUNCHES["ltc"] == 0  # capture ran nothing
    assert not any(ct.LAUNCHES.values())
    for _ in range(5):
        assert graph.replay() == ("gbuffers", "aux")  # the static outputs of the capture
    assert graph.graph.replays == 5
    assert bt.LAUNCHES == {"brute_closest": 15, "brute_any": 10} and lk.LAUNCHES["ltc"] == 5
    assert not any(ct.LAUNCHES.values())
    for mod in (bt, ct, lk):
        mod.reset_launch_counts()


def test_launch_recording_is_per_thread_and_not_nested():
    import threading

    counts = {"k": 0}
    with launches.recording() as tally:
        launches.count_launch(counts, "k")
        other = threading.Thread(target=launches.count_launch, args=(counts, "k"))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        with pytest.raises(RuntimeError, match="already open"):
            with launches.recording():
                pass
    assert tally == [(counts, "k")] and counts["k"] == 1  # the other thread's launch counted at once
    launches.count_launch(counts, "k")
    launches.add(tally)
    assert counts["k"] == 3


def test_frame_graph_refuses_cpu_buffers_without_touching_cuda(scenes, monkeypatch):
    def no_cuda(*args, **kwargs):
        raise AssertionError("touched CUDA")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_cuda)
    monkeypatch.setattr(torch.cuda, "graph", no_cuda)
    r = _renderer(scenes, "cornell", RendererType.PATH, res=8)
    buf = fg.FrameBuffers.for_frames(r.mode, 8, 8, r.path_depth, r.device)
    with pytest.raises(ValueError, match="FrameGraph captures CUDA work"):
        fg.FrameGraph(r._frame_key(), buf, r.device_scene, r.bvh, mode=r.mode, width=8, height=8,
                      path_depth=r.path_depth, ratio_samples=r.ratio_samples)
    assert not torch.cuda.is_initialized()
