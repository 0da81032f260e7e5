"""Where the benchmark finds each piece, by the names in ``BENCHMARK.json``.

* a cell: an entry of ``workloads``;
* its configuration: ``portbench/configs/<config>.json`` (named by the
  configuration's ``file``), whose ``scene`` names a committed scene JSON
  (``{"files": "portbench/scenes/<dir>/scene.json"}``);
* its traffic mix: ``portbench/traffic/<traffic>.json``, parameters of the
  driver it names (``harness.traffic``);
* its output check: ``portbench/checks/<workload>.json``, the sample sizes
  and the limit of the comparison with the plain reference;
* a metric: ``portbench/metrics/<name>.py``, or, for a metric split by the
  end-to-end metric it moves (``<quantity>.<split>``), the quantity's
  reader ``portbench/metrics/<quantity>.py``.  A reader is a module with
  ``read(record) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# what runs leave behind inside the checkout, at fixed paths (git-ignored)
CACHE_DIR = os.path.join(BENCH_DIR, "cache")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str, manifest: dict | None = None, root: str = ROOT) -> dict:
    """Everything one cell runs with: the manifest entries and the files
    they name, and the metrics it reports in each kind of run."""
    manifest = manifest or load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config_entry": config,
        "config": _json(root, config["file"]),
        "traffic": _json(BENCH_DIR, "traffic", f"{cell['traffic']}.json"),
        "check": _json(BENCH_DIR, "checks", f"{workload}.json"),
        "end_to_end": [m for m in manifest["end_to_end"] if reports(m)],
        "per_layer": [m for m in manifest["per_layer"] if reports(m)],
    }


def scene_json(config: dict) -> str:
    return os.path.join(ROOT, config["scene"]["files"])


def metric_reader(name: str):
    """The reader module of metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(BENCH_DIR, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under portbench/metrics/")
