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
``<mode>_preview.png``; ``--profile`` leaves a trace that holds the port's
spans, and the stage map beside it (null on the CPU).

The surfaces: ``--devices 4`` (PATH depth 2 on Cornell) writes the JAX
CLI's files, an image bit-equal to ``--devices 1`` with the same honest
ray count, and within the goldens' PATH tolerance (5e-3) of the JAX CLI's
``--devices 4``; ``--devices`` is refused for a height that does not
divide and for cards that do not exist; ``--bvh-cache`` writes one entry
that a second run loads without building; ``--serve`` is refused without
a card unless ``--cpu`` is given, and with ``--cpu`` serves (started and
stopped in-process, ``max_spp`` from ``--spp``).
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine import cli as jcli
from optix_renderer_tpu_torch.accel import build
from optix_renderer_tpu_torch.engine import cli
from optix_renderer_tpu_torch.engine.serve import ViewerServer

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
    assert sorted(os.listdir(prof)) == ["render_loop.pt.trace.json", "render_loop.stages.json"]
    with open(os.path.join(prof, "render_loop.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"renderer.render", "frame_graph.eager", "frame.camera_rng", "frame.bounce.combine"} <= names
    with open(os.path.join(prof, "render_loop.stages.json")) as f:
        assert json.load(f) is None  # frames on the CPU are no replays: no stage map


DEVICES_ARGV = ["--scene", CORNELL, "--renderer", "path", "--spp", "2", "--depth", "2", "--save-npy",
                "--save-gbuffers"]
PATH_TOL = 5e-3  # tests/goldens/test_goldens.py


@pytest.fixture(scope="module")
def devices_runs(tmp_path_factory):
    """Output dirs of the JAX CLI with --devices 4 and the port's with 4 and 1."""
    tmp = tmp_path_factory.mktemp("cli_devices")
    return (_run(jcli.main, tmp, "jax4", [*DEVICES_ARGV, "--devices", "4"]),
            _run(cli.main, tmp, "port4", [*DEVICES_ARGV, "--devices", "4"]),
            _run(cli.main, tmp, "port1", [*DEVICES_ARGV, "--devices", "1"]))


def test_devices_writes_the_jax_files(devices_runs):
    jax4, port4, _port1 = devices_runs
    assert sorted(os.listdir(port4)) == sorted(os.listdir(jax4))
    assert {"path.png", "path.npy", "gbuffer_normal.npy", "render.json"} <= set(os.listdir(port4))


def test_devices_image_equals_one_device(devices_runs):
    jax4, port4, port1 = devices_runs
    got = np.load(os.path.join(port4, "path.npy"))
    np.testing.assert_array_equal(got, np.load(os.path.join(port1, "path.npy")))
    np.testing.assert_array_equal(np.load(os.path.join(port4, "gbuffer_normal.npy")),
                                  np.load(os.path.join(port1, "gbuffer_normal.npy")))
    assert _rmse(got, np.load(os.path.join(jax4, "path.npy"))) < PATH_TOL
    manifests = []
    for out in (port4, port1):
        with open(os.path.join(out, "render.json")) as f:
            manifests.append(json.load(f))
    a, b = (m["metrics"] for m in manifests)
    assert manifests[0]["spp"] == 2 and a["frames"] == b["frames"] == 2
    assert a["rays_traced"] == b["rays_traced"] > 2 * 32 * 32  # the tiles' honest counts summed
    assert a["alive_per_bounce"] == b["alive_per_bounce"]


def test_devices_refusals(tmp_path):
    with pytest.raises(SystemExit, match="divide into 3 row tiles"):
        cli.main(["--scene", CORNELL, "--devices", "3", "--res", RES, "--out", str(tmp_path / "a"), "--cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal cannot be exercised")
    with pytest.raises(SystemExit, match="is_available"):
        cli.main(["--scene", CORNELL, "--devices", "2", "--res", RES, "--out", str(tmp_path / "b")])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


def test_bvh_cache_flag_writes_then_reads(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    argv = ["--scene", CORNELL, "--renderer", "normals", "--save-npy", "--bvh-cache", str(cache)]
    first = _run(cli.main, tmp_path, "first", argv)
    entries = sorted(os.listdir(cache))
    assert len(entries) == 1 and entries[0].startswith("torch-bvh-")
    monkeypatch.setattr(build, "build_bvh_arrays", lambda *a, **k: pytest.fail("the second run built the BVH"))
    second = _run(cli.main, tmp_path, "second", argv)
    assert sorted(os.listdir(cache)) == entries
    np.testing.assert_array_equal(np.load(os.path.join(second, "normals.npy")),
                                  np.load(os.path.join(first, "normals.npy")))


def test_serve_is_refused_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path cannot be exercised")
    with pytest.raises(SystemExit, match="is_available"):
        cli.main(["--scene", CORNELL, "--serve", "0", "--res", RES, "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_serve_runs_with_cpu(tmp_path, monkeypatch):
    """``--serve 0 --cpu --spp 2``: the CLI's server, started and stopped in
    process instead of blocking in ``serve_forever``; it renders up to
    max_spp = 2 and no further."""
    seen = {}

    def serve_briefly(server):
        server.start()
        try:
            t0 = time.monotonic()
            while server.status()["accum_id"] < 2:
                assert time.monotonic() - t0 < 60, "the viewer never reached 2 frames"
                time.sleep(0.02)
        finally:
            server.shutdown()
        seen.update(max_spp=server.max_spp, accum_id=server.r.state.accum_id, error=server.error,
                    scene_path=server.scene_path, png=server.frame_png()[:8])

    monkeypatch.setattr(ViewerServer, "serve_forever", serve_briefly)
    assert cli.main(["--scene", CORNELL, "--renderer", "path", "--depth", "2", "--spp", "2", "--serve", "0",
                     "--res", RES, "--out", str(tmp_path / "out"), "--cpu"]) == 0
    assert seen == {"max_spp": 2, "accum_id": 2, "error": None, "scene_path": CORNELL,
                    "png": b"\x89PNG\r\n\x1a\n"}
