"""The cell ``tetra3.ratio_progressive``: the plain RATIO reference against
the renderer's CPU path on a tiny copy of its scene (SPD's tetra at depth 3
under the configuration's three lights), its bfloat16 control, the
driver's request loop, and the LTC roofline's arithmetic."""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from portbench.control import control
from portbench.harness import check, traffic
from portbench.harness.cell import run_cell
from portbench.harness.manifest import ROOT, cell_spec, metric_reader
from portbench.reference import ltc as ref_ltc
from portbench.reference import ratio as ref_ratio
from portbench.reference import render as ref
from portbench.reference.scene import load_scene
from portbench.roofline import bytes as rb
from portbench.roofline import ltc as rl
from portbench.roofline.peaks import HBM_BYTES_PER_S

CELL = "tetra3.ratio_progressive"
SCENE = os.path.join(ROOT, "portbench", "scenes", "spd-tetra-3lights")
REL_TOL = cell_spec(CELL)["check"]["rel_tol"]
B6 = "(anonymous namespace)::ltc_kernel(float const*, float const*, float const*, float const*, float const*, int"


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """SPD's tetra at depth 3 (256 triangles) under the cell's three lights:
    the writer's tetra with the configuration's light files in place of its
    own light."""
    from optix_renderer_tpu_torch.scene import write_spd_tetra_scene

    out = str(tmp_path_factory.mktemp("tetra3"))
    path = write_spd_tetra_scene(out, depth=3)
    for name in ("light.obj", "light.mtl"):
        shutil.copy(os.path.join(SCENE, name), os.path.join(out, name))
    return path


def _port_buffers(path, res, frames, yaw):
    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene.config import SceneCamera, parse_scene

    r = Renderer(parse_scene(path), width=res, height=res, mode=RendererType.RATIO, ratio_samples=4, device="cpu")
    cam = traffic.orbit_camera(load_scene(path)["cameras"][0], yaw)
    r.set_camera(SceneCamera(from_=cam[0], at=cam[1], up=cam[2], cos_fovy=cam[3]))
    r.render(frames)
    bufs = {k: v.numpy().reshape(res * res, -1).astype(np.float64) for k, v in r.aux.items()}
    return bufs, cam, r


@pytest.mark.parametrize("yaw", [-7.5, 4.0])
def test_the_reference_agrees_with_the_renderer_on_a_tiny_tetra_under_three_lights(tiny_scene, yaw):
    res, frames = 32, 2
    got, cam, r = _port_buffers(tiny_scene, res, frames, yaw)
    assert r.device_scene.num_lights == 6 and r.bvh.num_tris == 4 ** 4 + 6
    tables = load_scene(tiny_scene)
    px = np.arange(res * res)
    want = ref_ratio.render_ratio_pixels(ref.RefScene(tables, "cpu"), cam, res, res, px, frames)
    assert (want["ltc"].max(axis=1) > 0).mean() > 0.5  # the tetra fills most of the frame, lit
    assert (want["sto_direct"] < want["sto_no_vis"] - 1e-3).mean() > 0.05  # and shadowed in places
    for k in ("ltc", "sto_direct", "sto_no_vis"):
        w = want[k].reshape(res * res, -1)
        assert check.off_share(got[k], w, REL_TOL) == 0.0, k
    answer = ref_ratio.combine(got["ltc"], got["sto_direct"][:, 0], got["sto_no_vis"][:, 0])
    assert check.off_share(answer, ref_ratio.combine(want["ltc"], want["sto_direct"], want["sto_no_vis"]),
                           REL_TOL) == 0.0


def test_the_bfloat16_reference_fails_the_same_check(tiny_scene):
    res, frames = 32, 2
    tables = load_scene(tiny_scene)
    cam = traffic.orbit_camera(tables["cameras"][0], 4.0)
    px = np.arange(res * res)
    answers = {}
    for dtype in (torch.float32, torch.bfloat16):
        b = ref_ratio.render_ratio_pixels(ref.RefScene(tables, "cpu", dtype), cam, res, res, px, frames)
        answers[dtype] = ref_ratio.combine(b["ltc"], b["sto_direct"], b["sto_no_vis"])
    assert check.off_share(answers[torch.bfloat16], answers[torch.float32], REL_TOL) > 50.0


def test_the_cells_control_fails_on_a_tiny_tetra(tiny_scene):
    over = {"config": {"scene": {"files": tiny_scene}, "width": 24, "height": 24},
            "traffic": {"frames_per_request": 2, "frames_per_call": 2}, "check": {"pixels": 200, "requests": 2}}
    res = control(CELL, 2 ** 31 + 211, "cpu", requests=3, overrides=over)
    assert res["off_pixels_pct"] > res["limit"]


def test_the_ltc_clip_keeps_what_lies_above_the_horizon():
    """A triangle wholly above the horizon keeps its three corners, one
    wholly below gives nothing, one with a corner below gives a quad."""
    up = [torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([[0.6, 0.0, 0.8]]), torch.tensor([[0.0, 0.6, 0.8]])]
    total, count = ref_ltc.clipped_integral(up)
    assert int(count) == 3 and float(total) > 0.0
    _, count = ref_ltc.clipped_integral([-c for c in up])
    assert int(count) == 0
    tilted = [torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([[0.8, 0.0, -0.6]]), torch.tensor([[0.0, 0.8, 0.6]])]
    part, count = ref_ltc.clipped_integral(tilted)
    assert int(count) == 4 and 0.0 < float(part)


def _tiny_run(tiny_scene, seed=2 ** 31 + 77):
    over = {"config": {"scene": {"files": tiny_scene}, "width": 16, "height": 16},
            "traffic": {"frames_per_request": 2, "frames_per_call": 2}, "check": {"pixels": 96, "requests": 2}}
    return run_cell(CELL, seed, 0.3, False, t_start=time.perf_counter(), device="cpu", overrides=over,
                    log=lambda *_: None)


def test_the_drivers_requests_on_the_cpu_are_correct(tiny_scene):
    out = _tiny_run(tiny_scene)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2 and out["attempted"] % 2 == 0
    assert set(out["metrics"]) == {"setup_s", "spp_per_s"}  # no peak memory on the CPU
    assert out["checks"]["off_pixels_pct"]["value"] == 0.0


def test_a_request_that_renders_half_its_frames_is_not_correct(tiny_scene, monkeypatch):
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    render = Renderer.render

    def half(self, n_frames=1):
        render(self, max(n_frames // 2, 1))
        self.state.accum_id = self.state.accum_id + n_frames - max(n_frames // 2, 1)

    monkeypatch.setattr(Renderer, "render", half)
    assert not _tiny_run(tiny_scene)["correct"]


def test_a_shadow_left_out_is_not_correct(tiny_scene, monkeypatch):
    """Visibility rays that never occlude make D equal N: the ratio is 1
    everywhere and the answer is the LTC term alone."""
    from optix_renderer_tpu_torch.integrators import ratio

    monkeypatch.setattr(ratio, "trace_any",
                        lambda bvh, rays, t_max: torch.zeros(rays.origin.shape[0], dtype=torch.bool))
    assert not _tiny_run(tiny_scene)["correct"]


def test_the_driver_refuses_a_request_of_two_calls():
    from portbench.traffic import ratio_requests

    with pytest.raises(ValueError, match="one render call"):
        ratio_requests.serve(None, {"frames_per_request": 16, "frames_per_call": 8}, traffic.Request(None), None)


def test_ltc_bytes():
    assert rl.ltc_bytes(2, 4, 3, 6) == 2 * (4 * 3 * (rb.RECORD_OUT + 12) + 6 * 48)
    assert rl.ltc_bytes(16, 1024, 1024, 6) == 16 * (1024 * 1024 * 16 + 288)


def test_ltc_roofline_reads_b6_alone():
    glue = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
    rec = {"width": 4, "height": 3, "lights": 6,
           "trace": {"ops": [(B6, 1e-6), (B6, 1e-6), (glue, 5e-3)], "frames": 2}}
    want = 100.0 * rl.ltc_bytes(2, 4, 3, 6) / HBM_BYTES_PER_S / 2e-6
    assert metric_reader("ltc_roofline.spp").read(rec) == pytest.approx(want)
    rec["trace"]["ops"] = [(glue, 5e-3)]
    assert metric_reader("ltc_roofline.spp").read(rec) is None
