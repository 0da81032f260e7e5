"""Builds of a kernel's source side by side on one CUDA card, against its
plain version and against each other: ``--kernel brute`` (the default),
``csrc/brute_trace.cu``'s B1 (closest hit) and B2 (occlusion) at the
Cornell shape and at the brute tier's cap; ``--kernel ltc``,
``csrc/ltc.cu``'s B6 on the LTC frames and random hits.

    python -m optix_renderer_tpu_torch.utils.brute_bench [--kernel brute|ltc]
        [--variant LABEL=SOURCE[,FLAG...]]... [--sass] [--rounds 2] [--out DIR]

A variant is a source file (``shipped`` is the package's own source of the
kernel; any other path, such as a copy with a design element taken out,
is taken from the working directory) compiled with the package's nvcc
flags plus its own, e.g. ``r4=shipped,-DBRUTE_RAYS_PER_THREAD=4``.  The flag ``+fma`` drops
``--fmad=false`` instead of adding anything, which lets nvcc contract
multiplies and adds; ``+vote`` launches B1 as for coherent rays (its warps
leave a test that none of their rays can pass) on every input, where
without it B1 runs as for incoherent rays on every input.  With no
``--variant`` the shipped build is measured alone, without the vote.

Inputs of ``brute`` (seed 20261016, as ``chip_smoke.py`` phase 3): on
``scenes/cornell`` (32 table rows) the 1024^2 primary rays of the first
frame and 1M bounce-like rays (30 % with ``t_max`` 0) for B1, and the
same 1M rays with shadow-like ``t_max`` for B2; the same three batches on
the terrain of ``write_terrain_scene(grid=46)``, the largest that stays in
the brute tier (4,062 triangles).  For each variant and input it counts
the rays on which the triangle id (or the occlusion bit) differs from the
plain version and those whose t differs beyond rtol 1e-5 / atol 1e-6,
then times every variant with CUDA events in turns (first to last, then
last to first, ``--rounds`` times) and prints the mean and the extremes.

Inputs of ``ltc`` (the same seed): the primary hits of the first LTC frame
at 1024^2 on ``scenes/cornell`` (2 triangle lights) and on
``scenes/cornell3`` (6), and 1M seeded random hits with 7 lights
(``bench_rays.random_ltc_hits``, with its edge lanes).  For each variant
and input it counts the rays whose three values are not bit-equal to the
plain version's (on the random hits also by edge lane, the ray's index mod
16), then times the variants in turns as above.

``--sass`` writes ``cuobjdump -sass`` of every build to ``--out`` and, for
``brute``, prints for the loops of ``closest_kernel`` and ``any_kernel`` that hold a
Moller-Trumbore test, the instructions by class; 27 multiplies are one
test, so ``FMUL / 27`` is the tests one pass of the loop serves.

Prints one JSON line per build, loop and (input, variant), with the SM
clock nvidia-smi reports straight after the input's timed launches, and a
last line with the card's name and power limit; the same lines go to
``results.jsonl`` under ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

SEED = 20261016
RES, RAYS, CAP_GRID = 1024, 1 << 20, 46
RTOL, ATOL = 1e-5, 1e-6
ITERS = {"cornell": 50, "cap": 5}
MULS_PER_TEST = 27
SASS_CLASSES = (  # first match wins
    ("shared loads", r"^LDS"), ("other loads", r"^LD"), ("f32 multiply/add", r"^(FMUL|FADD)"),
    ("division (MUFU, FFMA, FCHK, CALL)", r"^(MUFU|FFMA|FCHK|CALL)"), ("compares", r"^(FSETP|ISETP|PLOP3)"),
    ("selects and moves", r"^(FSEL|SEL|MOV|IMAD\.MOV)"), ("branches and barriers", r"^(BRA|BSSY|BSYNC|WARPSYNC|VOTE|BAR)"),
)


def _smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


PSEUDO_FLAGS = ("+fma", "+vote")


def parse_variant(text: str, shipped: str = "brute_trace.cu") -> tuple[str, str, tuple, bool]:
    """``label=source[,flag...]`` -> (label, source path, nvcc flags, B1
    votes); ``shipped`` names the package's source under csrc/."""
    from .cuda_build import CSRC_DIR, NVCC_FLAGS

    label, _, rest = text.partition("=")
    source, *extra = rest.split(",")
    flags = tuple(f for f in NVCC_FLAGS if not (f == "--fmad=false" and "+fma" in extra))
    flags += tuple(f for f in extra if f not in PSEUDO_FLAGS)
    path = os.path.join(CSRC_DIR, shipped) if source == "shipped" else os.path.abspath(source)
    return label, path, flags, "+vote" in extra


def sass_loops(sass: str, kernel: str) -> list[dict]:
    """The loops in a ``cuobjdump -sass`` listing, of every function whose
    (mangled) name holds ``kernel``, that hold at least one Moller-Trumbore
    test, shortest first: for each its instruction count, the count by class
    and the tests a pass serves.  The counts are static: a loop's rarely
    taken paths (the division's out-of-range case) count like the others."""
    functions: dict[str, list] = {}
    lines = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            lines = functions.setdefault(name, []) if kernel in name else None
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?);", ln)
        if lines is not None and m:
            text = re.sub(r"^@!?U?P\d+\s+", "", m.group(2).strip())
            lines.append((int(m.group(1), 16), text))
    loops = []
    for name, lines in functions.items():
        for addr, text in lines:
            m = re.match(r"BRA(\.\w+)*\s+(?:!?U?P\d+,\s*)?`?\(?(0x[0-9a-f]+)", text)
            if not m or int(m.group(2), 16) > addr:
                continue
            body = [t.split()[0] for a, t in lines if int(m.group(2), 16) <= a <= addr]
            n_mul = sum(op.startswith("FMUL") for op in body)
            if n_mul < MULS_PER_TEST:
                continue
            classes = {cls: 0 for cls, _ in SASS_CLASSES}
            classes["other"] = 0
            for op in body:
                classes[next((cls for cls, pat in SASS_CLASSES if re.match(pat, op)), "other")] += 1
            loops.append({"kernel": kernel, "function": name, "from": hex(int(m.group(2), 16)), "to": hex(addr),
                          "instructions": len(body), "tests": n_mul / MULS_PER_TEST,
                          "instructions_per_test": len(body) * MULS_PER_TEST / n_mul, "classes": classes})
    return sorted(loops, key=lambda lp: lp["instructions"])


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(device) -> list[dict]:
    """The six (scene, batch) inputs with their plain-version results."""
    from ..accel import brute_trace as bt
    from ..engine import RendererType
    from ..engine.renderer import Renderer, pixel_order
    from ..scene import parse_scene, write_terrain_scene
    from .bench_rays import bounce_like_rays, first_frame_primaries

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    scenes = {"cornell": parse_scene(os.path.join(root, "scenes", "cornell", "scene.json"))}
    with tempfile.TemporaryDirectory() as tmp:
        scenes["cap"] = parse_scene(write_terrain_scene(tmp, grid=CAP_GRID, width=RES, height=RES))
    inputs = []
    for scene, parsed in scenes.items():
        r = Renderer(parsed, width=RES, height=RES, mode=RendererType.NORMALS, device=device)
        assert not r.bvh.clustered, f"{scene}: {r.bvh.num_tris} triangles are above the brute tier"
        lin = (torch.arange(RES * RES, dtype=torch.int64, device=device) if scene == "cornell"
               else pixel_order(RES, RES, device))
        prim = first_frame_primaries(r, lin)
        o, d, tm_c, tm_a = bounce_like_rays(r.bvh, RAYS, device, SEED)
        tab = r.bvh.tri_tab
        for batch, kind, args in (
                ("primaries 1024^2", "closest", (prim.origin.contiguous(), prim.direction.contiguous(),
                                                 torch.full((RES * RES,), 3.0e38, device=device))),
                ("bounce 1M", "closest", (o, d, tm_c)), ("shadow 1M", "any", (o, d, tm_a))):
            plain = (bt.trace_closest_plain if kind == "closest" else bt.trace_any_plain)(tab, *args)
            inputs.append({"scene": scene, "triangles": r.bvh.num_tris, "rows": tab.shape[0], "batch": batch,
                           "kind": kind, "args": (tab, *args), "plain": plain,
                           "live_share": (args[2] > 0).float().mean().item()})
    torch.cuda.synchronize()
    return inputs


LTC_RES, LTC_RANDOM_RAYS, LTC_RANDOM_LIGHTS, LTC_ITERS = 1024, 1 << 20, 7, 20


def make_ltc_inputs(device) -> list[dict]:
    """The three B6 inputs with their plain-version results."""
    from ..engine import RendererType
    from ..engine.renderer import Renderer
    from ..scene import parse_scene
    from ..shading import ltc_kernel as lk
    from .bench_rays import ltc_frame_inputs, random_ltc_inputs

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    inputs = []
    for scene in ("cornell", "cornell3"):
        r = Renderer(parse_scene(os.path.join(root, "scenes", scene, "scene.json")), width=LTC_RES,
                     height=LTC_RES, mode=RendererType.LTC_BASELINE, device=device)
        inputs.append({"input": f"{scene} LTC frame {LTC_RES}^2", "args": ltc_frame_inputs(r)})
    inputs.append({"input": f"random {LTC_RANDOM_RAYS}",
                   "args": random_ltc_inputs(LTC_RANDOM_RAYS, LTC_RANDOM_LIGHTS, SEED, device),
                   "edge_case": torch.arange(LTC_RANDOM_RAYS, device=device) % 16})
    for inp in inputs:
        inp["plain"] = lk.ltc_direct_plain(*inp["args"])
    torch.cuda.synchronize()
    return inputs


def compare_ltc(inp: dict, got) -> dict:
    """Rays whose three values are not bit-equal to the plain version's (a
    NaN equals a NaN); on the random hits also by edge lane."""
    plain = inp["plain"]
    unequal = ~((got == plain) | (got.isnan() & plain.isnan())).all(dim=-1)
    out = {"rays": plain.shape[0], "lights": inp["args"][5].shape[0], "rays_not_bit_equal": int(unequal.sum().item())}
    if "edge_case" in inp:  # lane k of the random hits is edge case k % 16 (bench_rays.LTC_EDGE_CASES)
        out["by_lane_mod_16"] = torch.bincount(inp["edge_case"][unequal], minlength=16).tolist()
    return out


def compare(inp: dict, got) -> dict:
    """Rays on which a kernel's result differs from the plain version's."""
    if inp["kind"] == "any":
        return {"rays": got.numel(), "occluded": int(inp["plain"].sum().item()),
                "occlusion_differs": int((got != inp["plain"]).sum().item())}
    (t, tri_id, _u, _v), (t_p, id_p, _up, _vp) = got, inp["plain"]
    far = (t - t_p).abs() > ATOL + RTOL * t_p.abs()
    return {"rays": t.numel(), "hits": int((id_p >= 0).sum().item()), "id_differs": int((tri_id != id_p).sum().item()),
            "t_differs": int(far.sum().item())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("brute", "ltc"), default="brute")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL=SOURCE[,FLAG...]")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="default chiprun_out/<kernel>_bench")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("brute_bench: torch.cuda.is_available() is false; it needs a CUDA GPU", file=sys.stderr)
        return 1
    from ..accel import brute_trace as bt
    from ..shading import ltc_kernel as lk
    from . import cuda_build

    ltc = args.kernel == "ltc"
    mod, shipped = (lk, "ltc.cu") if ltc else (bt, "brute_trace.cu")
    smi = _smi("name,power.limit")
    args.out = args.out or f"chiprun_out/{args.kernel}_bench"
    os.makedirs(args.out, exist_ok=True)
    results = open(os.path.join(args.out, "results.jsonl"), "w")

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        results.write(line + "\n")

    libs, votes = {}, {}
    for text in args.variant or ["shipped=shipped"]:
        label, path, flags, vote = parse_variant(text, shipped)
        votes[label] = vote
        lib_path, _ = cuda_build.build_library(f"{shipped[:-3]}_{label}", [path], flags)
        with open(lib_path + ".log") as f:
            usage = [ln.split("info    :")[-1].strip() for ln in f if "Used" in ln or "spill" in ln]
        emit({"variant": label, "source": os.path.relpath(path),
              "flags": [f for f in flags if f not in cuda_build.NVCC_FLAGS], "fmad_false": "--fmad=false" in flags,
              **({} if ltc else {"b1_votes": vote}), "ptxas": usage})
        libs[label] = mod.bind_library(ctypes.CDLL(lib_path))
        if args.sass:
            dump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
            sass = subprocess.run([dump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
            with open(os.path.join(args.out, f"{label}.sass"), "w") as f:
                f.write(sass)
            for kernel in () if ltc else ("closest_kernel", "any_kernel"):
                for loop in sass_loops(sass, kernel):
                    emit({"variant": label, **loop})

    def run(label, inp):
        mod._lib = libs[label]  # the wrappers launch whichever build is bound
        if ltc:
            return lk.ltc_direct_cuda(*inp["args"])
        if inp["kind"] == "any":
            return bt.trace_any_cuda(*inp["args"])
        return bt.trace_closest_cuda(*inp["args"], coherent=votes[label])

    for inp in (make_ltc_inputs if ltc else make_inputs)(torch.device("cuda", 0)):
        diffs = {label: (compare_ltc if ltc else compare)(inp, run(label, inp)) for label in libs}
        torch.cuda.synchronize()
        times = {label: [] for label in libs}
        for _ in range(args.rounds):
            for label in (*libs, *reversed(libs)):
                times[label].append(_time_ms(lambda: run(label, inp), LTC_ITERS if ltc else ITERS[inp["scene"]]))
        clock = _smi("clocks.sm")  # read straight after the timed launches
        for label, ms in times.items():
            about = ({"kernel": "B6", "input": inp["input"]} if ltc else
                     {"scene": inp["scene"], "triangles": inp["triangles"], "rows": inp["rows"],
                      "batch": inp["batch"], "kernel": "B1" if inp["kind"] == "closest" else "B2",
                      "live_share": inp["live_share"]})
            emit({**about, "variant": label, "ms": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
                  "sm_clock_after": clock, **diffs[label]})
    results.write(smi + "\n")
    results.close()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
