"""The traffic driver: the same seed gives the same cameras, every seed the
same kind of work."""

import itertools

import numpy as np
import pytest

from portbench.harness import check, traffic
from portbench.harness.manifest import cell_spec, load_manifest

CELLS = [w["name"] for w in load_manifest()["workloads"]]
DRIVER = traffic.load_driver("image_requests")
BASE = (np.array([278.0, 273.0, -800.0], np.float32), np.array([278.0, 273.0, 279.6], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32), 0.66)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_cameras(cell):
    mix = cell_spec(cell)["traffic"]
    seed = 2 ** 31 + 977
    cams = [list(itertools.islice(traffic.load_driver(mix["driver"]).cameras(mix, BASE, s), 50))
            for s in (seed, seed, seed + 1)]
    a, b, c = ([np.concatenate([cam[0] for cam in cs]) for cs in cams])
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_arc_covers_the_arc_alike_for_every_seed():
    mix = {"arc_deg": 12.0}
    d0 = BASE[0] - BASE[1]
    for seed in (1, 2 ** 31 + 5, 2 ** 32 + 3):
        ys = []
        for cam in itertools.islice(DRIVER.cameras(mix, BASE, seed), 64):
            d = cam[0] - cam[1]
            ys.append(np.degrees(np.arctan2(d0[0] * d[2] - d0[2] * d[0], d0[0] * d[0] + d0[2] * d[2])))
        hist, _ = np.histogram(ys, bins=8, range=(-12, 12))
        assert hist.min() >= 6 and max(np.abs(ys)) <= 12.0 + 1e-3


def test_orbit_camera_keeps_target_height_and_distance():
    cam = BASE
    turned = traffic.orbit_camera(cam, 12.0)
    d0 = np.linalg.norm(cam[0] - cam[1])
    d1 = np.linalg.norm(turned[0] - turned[1])
    assert d1 == pytest.approx(d0, rel=1e-6) and turned[0][1] == cam[0][1]
    assert np.array_equal(traffic.orbit_camera(cam, 0.0)[0], cam[0])


def test_request_calls():
    calls = DRIVER.calls
    assert calls({"frames_per_request": 64, "frames_per_call": 16}) == [16] * 4
    assert calls({"frames_per_request": 5, "frames_per_call": 2}) == [2, 2, 1]
    assert calls({"frames_per_request": 1}) == [1]


def test_every_mix_names_a_driver():
    import glob, json, os
    for path in glob.glob(os.path.join(traffic.BENCH_DIR, "traffic", "*.json")):
        with open(path) as f:
            mix = json.load(f)
        assert callable(traffic.load_driver(mix["driver"]).reference), path


def test_samples_are_seeded():
    a = check.sampled_pixels(1024, 1024, 4096, 2 ** 31 + 1)
    assert np.array_equal(a, check.sampled_pixels(1024, 1024, 4096, 2 ** 31 + 1))
    assert len(np.unique(a)) == 4096 and a.max() < 1024 * 1024
    assert check.chosen_requests(67, 3, 9) == check.chosen_requests(67, 3, 9)
    assert check.chosen_requests(2, 3, 9) == [0, 1]
