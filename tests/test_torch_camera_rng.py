"""Kernel K0, a frame's camera and RNG head (``engine.camera_kernel``).

On the CPU: a frame never loads K0's library nor counts a launch, and the
wrapper refuses a camera off the card without touching CUDA.

On a CUDA card (skipped without one): K0's states, origins and directions
bit-equal to ``camera_rng_plain`` run on the card, with the frame id as an
int and as a 0-d tensor, at 1024^2 (frame ids 0 and 2^32 - 10000, where
``frame_id + 10007`` wraps past 2^32), on a split tile (rows 256-511), at
1000 x 600 (block edges 8 and 8) and 30 x 17 (block edges 2 and 1); four
replays of a captured graph that reads the id from the device, each equal
to the eager kernel at that id; one launch a frame through the Renderer's
frame graph and none with ``plain=True``.  This file imports no JAX, so it
runs on the card as
``python -m pytest --noconftest tests/test_torch_camera_rng.py``.
"""

from __future__ import annotations

import os

import pytest
import torch

from optix_renderer_tpu_torch.engine import camera_kernel as ck
from optix_renderer_tpu_torch.engine.camera import camera_from_lookat
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.scene import parse_scene
from optix_renderer_tpu_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell", "scene.json")
# (width, height, row_offset, rows, frame id)
CASES = [(1024, 1024, 0, None, 0), (1024, 1024, 0, None, 2**32 - 10000), (1024, 1024, 256, 256, 5),
         (1000, 600, 0, None, 3), (30, 17, 0, None, 7)]


@pytest.fixture(scope="module")
def cornell():
    return parse_scene(CORNELL)


def _camera(scene, width, height, device):
    cam = scene.cameras[0]
    return camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, width, height, device)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("K0 is a CUDA kernel: it runs only on a CUDA card")
    return torch.device("cuda", 0)


def _assert_bit_equal(got, want, label):
    (g_ray, g_state), (w_ray, w_state) = got, want
    assert g_state.dtype == w_state.dtype == torch.int64 and torch.equal(g_state, w_state), f"{label}: state"
    for name in ("origin", "direction"):
        g, w = getattr(g_ray, name), getattr(w_ray, name)
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32 and g.is_contiguous(), f"{label}: {name}"
        diff = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        assert diff == 0, f"{label}: {name} differs from the plain version's bits on {diff} values"


def test_a_cpu_frame_never_loads_the_camera_kernel(cornell, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("loaded a CUDA library")

    monkeypatch.setattr(ck, "kernel_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    ck.reset_launch_counts()
    r = Renderer(cornell, width=16, height=8, mode=RendererType.PATH, path_depth=2, device="cpu")
    r.render(3)
    _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=16, height=8, path_depth=2, ratio_samples=1)
    assert r.image().mean() > 0
    assert ck.LAUNCHES == {"camera_rng": 0}
    assert not torch.cuda.is_initialized()


def test_the_wrapper_refuses_a_camera_off_the_card(cornell):
    cam = _camera(cornell, 8, 8, "cpu")
    with pytest.raises(ValueError, match="camera on a CUDA device"):
        ck.camera_rng_cuda(cam, 0, 8, 8)
    rays, state = ck.camera_rng(cam, 0, 8, 8)  # the router takes the plain version on the CPU
    want_rays, want_state = ck.camera_rng_plain(cam, 0, 8, 8)
    assert torch.equal(state, want_state) and torch.equal(rays.direction, want_rays.direction)
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("width,height,row_offset,rows,frame_id", CASES)
def test_k0_bit_equal_to_the_plain_version_on_the_card(cornell, width, height, row_offset, rows, frame_id):
    dev = _card()
    cam = _camera(cornell, width, height, dev)
    want = ck.camera_rng_plain(cam, frame_id, width, height, row_offset, rows)
    label = f"{width}x{height} rows {row_offset}+{rows} frame {frame_id}"
    _assert_bit_equal(ck.camera_rng_cuda(cam, frame_id, width, height, row_offset, rows), want, label)
    fid = torch.tensor(frame_id, dtype=torch.int64, device=dev)
    _assert_bit_equal(ck.camera_rng_cuda(cam, fid, width, height, row_offset, rows), want, label + " (tensor id)")
    torch.cuda.synchronize(dev)


def test_k0_in_a_captured_graph_reads_the_frame_id_from_the_device(cornell):
    dev = _card()
    cam = _camera(cornell, 1024, 1024, dev)
    fid = torch.zeros((), dtype=torch.int64, device=dev)
    ck.camera_rng_cuda(cam, fid, 1024, 1024)  # the library loads outside the capture
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rays, state = ck.camera_rng_cuda(cam, fid, 1024, 1024)
    for frame_id in (1, 2, 2**31 + 5, 2**32 - 10000):
        fid.fill_(frame_id)
        graph.replay()
        want = ck.camera_rng_cuda(cam, frame_id, 1024, 1024)
        _assert_bit_equal((rays, state), want, f"replay at frame {frame_id}")
        _assert_bit_equal(want, ck.camera_rng_plain(cam, frame_id, 1024, 1024), f"eager at frame {frame_id}")
    torch.cuda.synchronize(dev)


def test_k0_launches_once_a_frame_and_never_with_plain(cornell):
    dev = _card()
    r = Renderer(cornell, width=64, height=64, mode=RendererType.PATH, path_depth=2, device=dev)
    ck.reset_launch_counts()
    r.render(4)  # the key's eager frame, the capture (which runs nothing), three replays
    r.render(2)
    torch.cuda.synchronize(dev)
    assert ck.LAUNCHES["camera_rng"] == 6
    ck.reset_launch_counts()
    state, *_ = _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=64, height=64, path_depth=2,
                            ratio_samples=1, plain=True)
    torch.cuda.synchronize(dev)
    assert ck.LAUNCHES["camera_rng"] == 0 and state.accum_id == r.state.accum_id + 1
