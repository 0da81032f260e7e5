"""The benchmark's plain reference reads its LTC lookup tables from
``portbench/reference/ltc_isotropic.json``, a transcription of the
reference renderer's ``include/ltc/ltc_isotropic.h:4-8``.  Its numbers
are held here to the JAX package's transcription of the same header
(``optix_renderer_tpu/shading/ltc_tables.py``), which the port's copy does
not feed: every decimal as written there, and the float32 tables that
module builds, table by table.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON = os.path.join(ROOT, "portbench", "reference", "ltc_isotropic.json")
JAX_TABLES = os.path.join(ROOT, "optix_renderer_tpu", "shading", "ltc_tables.py")


def _literals(name: str) -> list[float]:
    """The decimals of ``name = np.asarray([...])`` in the JAX package's file, as written."""
    with open(JAX_TABLES) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            asarray = node.value.func.value  # np.asarray([...], dtype=...).reshape(8, 8, 4)
            return [float(ast.literal_eval(e)) for e in asarray.args[0].elts]
    raise AssertionError(f"no {name} in {JAX_TABLES}")


def _jax_tables():
    """The JAX package's module, loaded from its file alone (it needs numpy, not JAX)."""
    spec = importlib.util.spec_from_file_location("jax_ltc_tables", JAX_TABLES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("table", [1, 2, 3])
def test_the_reference_lut_equals_the_jax_package_transcription(table):
    with open(JSON) as f:
        got = json.load(f)[f"ltc{table}"]
    assert np.asarray(got).shape == (8, 8, 4)
    flat = [v for row in got for texel in row for v in texel]
    assert flat == _literals(f"LTC_ISO_{table}")  # the same decimals, not float32 round trips
    want = getattr(_jax_tables(), f"LTC_ISO_{table}")
    assert want.dtype == np.float32 and np.array_equal(np.asarray(got, np.float32), want)
