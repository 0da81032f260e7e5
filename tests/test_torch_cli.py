"""The port's CLI (``optix_renderer_tpu_torch.engine.cli``) against the JAX
CLI (``optix_renderer_tpu.engine.cli``) on the CPU, at 32^2.

Both CLIs run in this process (``main(argv)`` with ``--cpu``).  Three JAX
runs, each in a module-scoped fixture: RATIO on ``scenes/cornell3`` with
``--save-gbuffers --save-exr --denoise-ratio``, with and without
``--save-npy``, and NORMALS on a copy of ``scenes/cornell`` under a
temporary directory with ``--cam-from/--cam-to/--cam-fovy --record-camera
--save-npy``.  Held: the set of files both CLIs write for the same flags;
no ``ratio_final.npy`` without ``--save-npy``; the moved camera's NORMALS
image within relative RMSE 1e-4 (the goldens' tolerance; both render the
same camera through the same arithmetic); the recorded camera entry equal;
``--camera 1`` on the recorded scene rendering the ``--cam-*`` image, and
an index past the end rendering camera 0.  Port-only: ``--preview`` writes
``<mode>_preview.png``; ``--profile`` leaves a non-empty trace.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine import cli as jcli
from optix_renderer_tpu_torch.engine import cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL, CORNELL3 = (os.path.join(REPO, "scenes", s, "scene.json") for s in ("cornell", "cornell3"))
RES = "32"
RATIO_FLAGS = {"npy": ["--save-gbuffers", "--save-exr", "--denoise-ratio", "--save-npy"],
               "no_npy": ["--save-gbuffers", "--save-exr", "--denoise-ratio"]}
CAM_FLAGS = ["--renderer", "normals", "--cam-from", "300", "250", "-700", "--cam-to", "260", "280", "280",
             "--cam-fovy", "0.6", "--save-npy"]
RMSE_TOL = 1e-4


def _run(main, tmp, name: str, argv: list) -> str:
    out = str(tmp / name)
    assert main([*argv, "--res", RES, "--out", out, "--cpu"]) == 0
    return out


def _rmse(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


@pytest.fixture(scope="module", params=sorted(RATIO_FLAGS))
def ratio_runs(request, tmp_path_factory):
    """(JAX output dir, port output dir) of one RATIO flag set."""
    tmp = tmp_path_factory.mktemp(f"cli_ratio_{request.param}")
    argv = ["--scene", CORNELL3, "--renderer", "ratio", "--spp", "2", *RATIO_FLAGS[request.param]]
    return request.param, _run(jcli.main, tmp, "jax", argv), _run(cli.main, tmp, "port", argv)


@pytest.fixture(scope="module")
def cam_runs(tmp_path_factory):
    """Each CLI on its own copy of scenes/cornell with the moved camera
    recorded: (JAX scene, JAX out, port scene, port out)."""
    tmp = tmp_path_factory.mktemp("cli_cam")
    dirs = {}
    for who, main in (("jax", jcli.main), ("port", cli.main)):
        scene_dir = tmp / f"scene_{who}"
        shutil.copytree(os.path.dirname(CORNELL), scene_dir)
        scene = str(scene_dir / "scene.json")
        dirs[who] = (scene, _run(main, tmp, who, ["--scene", scene, *CAM_FLAGS, "--record-camera"]))
    return (*dirs["jax"], *dirs["port"])


def test_ratio_outputs_match_jax_files(ratio_runs):
    _flags, jax_out, port_out = ratio_runs
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    assert {"gbuffer_normal.png", "gbuffer_normal.exr", "ratio.exr", "ratio_final.png"} <= set(os.listdir(port_out))


def test_ratio_final_npy_only_with_save_npy(ratio_runs):
    flags, _jax_out, port_out = ratio_runs
    files = set(os.listdir(port_out))
    assert ("ratio_final.npy" in files) == (flags == "npy")
    assert ("gbuffer_normal.npy" in files) == (flags == "npy")


def test_cam_flags_render_the_jax_image(cam_runs):
    _js, jax_out, _ps, port_out = cam_runs
    want, got = np.load(os.path.join(jax_out, "normals.npy")), np.load(os.path.join(port_out, "normals.npy"))
    assert got.shape == (32, 32, 3) and np.abs(got).mean() > 0
    assert _rmse(got, want) < RMSE_TOL


def test_record_camera_appends_the_jax_entry(cam_runs):
    jax_scene, _jo, port_scene, _po = cam_runs
    with open(jax_scene) as f:
        want = json.load(f)["cameras"]
    with open(port_scene) as f:
        got = json.load(f)["cameras"]
    assert len(got) == 2 and got == want
    assert got[1]["from"] == [300.0, 250.0, -700.0] and got[1]["cos_fovy"] == pytest.approx(0.6)


def test_camera_index_renders_the_recorded_camera(cam_runs, tmp_path):
    _js, _jo, port_scene, port_out = cam_runs
    again = _run(cli.main, tmp_path, "again", ["--scene", port_scene, "--renderer", "normals", "--camera", "1",
                                                "--save-npy"])
    np.testing.assert_array_equal(np.load(os.path.join(again, "normals.npy")),
                                  np.load(os.path.join(port_out, "normals.npy")))
    # an index past the end falls back to camera 0, as in the JAX CLI
    past = _run(cli.main, tmp_path, "past", ["--scene", port_scene, "--renderer", "normals", "--camera", "9",
                                             "--save-npy"])
    first = _run(cli.main, tmp_path, "first", ["--scene", port_scene, "--renderer", "normals", "--save-npy"])
    np.testing.assert_array_equal(np.load(os.path.join(past, "normals.npy")),
                                  np.load(os.path.join(first, "normals.npy")))
    assert not np.array_equal(np.load(os.path.join(first, "normals.npy")),
                              np.load(os.path.join(port_out, "normals.npy")))


@pytest.fixture(scope="module")
def preview_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_preview")
    prof = tmp / "prof"
    out = _run(cli.main, tmp, "out", ["--scene", CORNELL, "--renderer", "path", "--spp", "4", "--depth", "2",
                                      "--preview", "2", "--profile", str(prof)])
    return out, str(prof)


def test_preview_writes_the_preview_png(preview_run):
    out, _prof = preview_run
    assert {"path.png", "path_preview.png", "render.json"} <= set(os.listdir(out))
    with open(os.path.join(out, "render.json")) as f:
        assert json.load(f)["spp"] == 4  # two previews of 2 frames each


def test_profile_leaves_a_trace(preview_run):
    _out, prof = preview_run
    traces = [os.path.join(prof, f) for f in os.listdir(prof)]
    assert traces and all(os.path.getsize(t) > 0 for t in traces)
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
