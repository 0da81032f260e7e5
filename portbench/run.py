"""Run one cell of the benchmark once, on one CUDA card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's progress, then on standard
error the numbers compared with their limits, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.  Exits 2 without a result when no
CUDA card is there, 3 when a module of JAX or of the JAX package is loaded
once everything else is done, just before the result would be printed,
1 on any other fault.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "cache")  # harness.manifest.CACHE_DIR, before torch is imported
# kernel caches at fixed paths inside the checkout (the renderer keeps its nvcc
# libraries in optix_renderer_tpu_torch/_build/ beside its sources)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.cell import forbidden_modules, run_cell
    from portbench.harness.manifest import cell_spec

    chips = int(cell_spec(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {bad}; no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
