"""The port's own host modules against the JAX package's.

The port keeps copies of the numpy-only scene code (``scene.config``,
``scene.obj_loader`` with its native parser, ``scene.procedural``), so it
imports nothing of ``optix_renderer_tpu``.  Every array that the two
``parse_scene`` produce must be equal, on the committed scenes and on a
grid-60 terrain, and the procedural writers (Cornell, Cornell-3, the
gallery with its four textures, the terrain) must write the same files.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from optix_renderer_tpu.scene import procedural as jproc
from optix_renderer_tpu.scene.config import parse_scene as jparse
from optix_renderer_tpu_torch.native import get_objparse
from optix_renderer_tpu_torch.scene import procedural
from optix_renderer_tpu_torch.scene.config import parse_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERRAIN_GRID = 60


def _assert_same(a, b, where: str) -> None:
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def terrain_json(tmp_path_factory):
    return procedural.write_terrain_scene(str(tmp_path_factory.mktemp("terrain")), grid=TERRAIN_GRID,
                                          width=32, height=32)


@pytest.mark.parametrize("name", ["cornell", "cornell3", "gallery", "terrain"])
def test_parse_scene_matches_jax(name, terrain_json):
    path = terrain_json if name == "terrain" else os.path.join(REPO, "scenes", name, "scene.json")
    got, want = parse_scene(path), jparse(path)
    _assert_same(got, want, name)
    if name == "terrain":
        assert sum(len(m.index) for m in got.model.meshes) > 4096  # the cluster tier's scene


def test_native_parser_builds():
    """The copied C++ OBJ parser builds into the port's _build/ (g++ is
    on the test machine): the 1M-triangle terrain must not take the
    pure-Python parse."""
    assert get_objparse() is not None


@pytest.mark.parametrize("writer", ["write_cornell_scene", "write_terrain_scene", "write_cornell3_scene",
                                    "write_gallery_scene"])
def test_procedural_writes_the_jax_files(writer, tmp_path):
    kwargs = {"write_terrain_scene": {"grid": 12}, "write_gallery_scene": {"sphere_grid": 3}}.get(writer, {})
    a = getattr(procedural, writer)(str(tmp_path / "port"), width=16, height=16, **kwargs)
    b = getattr(jproc, writer)(str(tmp_path / "jax"), width=16, height=16, **kwargs)
    names = sorted(os.listdir(os.path.dirname(b)))
    assert sorted(os.listdir(os.path.dirname(a))) == names
    match, mismatch, errors = filecmp.cmpfiles(os.path.dirname(a), os.path.dirname(b), names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
