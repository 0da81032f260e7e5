"""A run of the harness on the CPU at a tiny size (its look for a card
skipped), with the timed path intact and with it broken underneath."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench.harness.cell import run_cell
from portbench.harness.manifest import ROOT

from .helpers import TINY, TINY_CORNELL

CELLS = sorted(TINY)


def _run(workload="cornell.path_progressive", overrides=TINY_CORNELL, trace=False, seed=2 ** 31 + 7):
    return run_cell(workload, seed, 0.3, trace, t_start=time.perf_counter(), device="cpu",
                    overrides=overrides, log=lambda *_: None)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"setup_s", "spp_per_s"}
    assert list(out)[-1] == "checks" and out["checks"]["off_pixels_pct"]["value"] == 0.0
    assert out["device"]["platform"] == "cpu"


def test_a_traced_run_on_the_cpu_reports_no_device_metric():
    out = _run(trace=True)
    assert out["correct"] and out["metrics"] == {}
    assert out["device"]["busy_s"] == 0.0 and out["breakdown"]["device_ops"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch, cell):
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    monkeypatch.setattr(Renderer, "render", lambda self, n_frames=1: None)
    assert not _run(cell, TINY[cell])["correct"]


def test_half_the_frames_left_out_is_not_correct(monkeypatch):
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    render = Renderer.render

    def half(self, n_frames=1):
        render(self, max(n_frames // 2, 1))
        self.state.accum_id = self.state.accum_id + n_frames - max(n_frames // 2, 1)  # counted, not rendered

    monkeypatch.setattr(Renderer, "render", half)
    assert not _run()["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_pixels_left_out_is_not_correct(monkeypatch, cell):
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    image = Renderer.image

    def half(self):
        img = image(self).copy()
        img[: img.shape[0] // 2] = 0.0
        return img

    monkeypatch.setattr(Renderer, "image", half)
    assert not _run(cell, TINY[cell])["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch, cell):
    from optix_renderer_tpu_torch.engine.renderer import Renderer

    image = Renderer.image
    monkeypatch.setattr(Renderer, "image", lambda self: image(self) * np.float32(1.01))
    assert not _run(cell, TINY[cell])["correct"]


def test_no_module_of_jax_or_the_jax_package_after_a_run():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench.harness.cell import run_cell, forbidden_modules\n"
            "from portbench.tests.helpers import TINY_CORNELL\n"
            "out = run_cell('cornell.path_progressive', 5, 0.2, False, t_start=time.perf_counter(), device='cpu',\n"
            "               overrides=TINY_CORNELL, log=lambda *_: None)\n"
            "print(out['correct'], forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True []"


@pytest.mark.parametrize("planted", [False, True])
def test_a_module_of_jax_loaded_after_the_window_stops_the_result(tmp_path, planted):
    """run.py with its look for a card answered yes, on the CPU: with a metric
    reader that imports ``jax`` (a stand-in package of that name) once the
    window has closed it prints no result and exits 3; without, it prints
    the result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    code = ("import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from portbench import run\n"
            "from portbench.harness import cell\n"
            "from portbench.tests.helpers import TINY_CORNELL\n"
            "real_run, real_reader = cell.run_cell, cell.metric_reader\n"
            "class Planted:\n"
            "    def __init__(self, name): self.inner = real_reader(name)\n"
            "    def read(self, record):\n"
            "        import jax  # noqa: F401\n"
            "        return self.inner.read(record)\n"
            "if %r: cell.metric_reader = Planted\n"
            "cell.run_cell = lambda *a, **k: real_run(*a, **k, device='cpu', overrides=TINY_CORNELL)\n"
            "sys.exit(run.main(['--workload', 'cornell.path_progressive', '--seed', '9', '--seconds', '0.2',"
            " '--trace', '0']))" % (ROOT, str(tmp_path), planted))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    results = [line for line in out.stdout.splitlines() if line.startswith("{")]
    if planted:
        assert out.returncode == 3 and results == [], out.stderr
        assert "jax" in out.stderr.strip().splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_run_exits_without_a_result_when_there_is_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is there")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.path_progressive",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_harness_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench.harness.cell import run_cell\n"
            "run_cell('cornell.path_progressive', 1, 0.1, False, t_start=time.perf_counter(), device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "optix_renderer_tpu_torch" in out.stderr
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.path_progressive",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_on_the_card(cuda):
    out = run_cell("cornell.path_progressive", 2 ** 31 + 11, 2.0, False, t_start=time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
    json.dumps(out)
