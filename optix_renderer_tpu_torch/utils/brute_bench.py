"""Builds of a kernel's source side by side on one CUDA card, against its
plain version and against each other: ``--kernel brute`` (the default),
``csrc/brute_trace.cu``'s B1 (closest hit) and B2 (occlusion) at the
Cornell shape and at the brute tier's cap; ``--kernel ltc``,
``csrc/ltc.cu``'s B6 on the LTC frames and random hits; ``--kernel
bounce``, ``csrc/path_bounce.cu``'s K1 and ``csrc/brute_shade.cu``'s K3 on
an eager Cornell PATH frame's inputs and K3 at the brute tier's cap.

    python -m optix_renderer_tpu_torch.utils.brute_bench [--kernel brute|ltc|bounce]
        [--variant LABEL=SOURCE[,FLAG...]]... [--sass] [--rounds 2] [--out DIR]

A variant is a source file (``shipped`` is the package's own source of the
kernel; any other path, such as a copy with a design element taken out,
is taken from the working directory; for ``bounce`` it is a directory
holding both ``path_bounce.cu`` and ``brute_shade.cu``, and the headers
they include (``shade_common.cuh``), and ``shipped`` is ``csrc/``) compiled with the package's nvcc
flags plus its own, e.g. ``r4=shipped,-DBRUTE_RAYS_PER_THREAD=4``.  The flag ``+fma`` drops
``--fmad=false`` instead of adding anything, which lets nvcc contract
multiplies and adds; ``+vote`` launches B1 as for coherent rays (its warps
leave a test that none of their rays can pass) on every input, where
without it B1 runs as for incoherent rays on every input; ``+pack35``
hands K3 ``tri_pack`` itself (35 floats a row, as the kernel before the
padded table read it) instead of ``shade_kernel.padded_pack``'s copy.  With no
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

Inputs of ``bounce`` (the same seed): one eager ``_frame_impl`` frame of
``scenes/cornell`` in PATH depth 4 at 1024^2 with the wrappers recording
their arguments (``bench_rays.record_bounce_inputs``, as ``chip_smoke.py``
phase 3): K1 at its second bounce, K3 at its primaries and at its second
bounce; and K3 on 1M seeded hits (``bench_rays.random_shade_hits``) on the
terrain of ``write_terrain_scene(grid=46)``, the brute tier's largest
table.  For each variant and input it counts the lanes on which any output
is not bit-equal to the plain version's (``path_sample_plain``,
``build_surface_interaction``), then times the variants in turns as above,
each turn twice: ``ms`` from one CUDA graph of 30 launches replayed
between CUDA events (the device time, as in a replayed frame) and
``ms_eager`` from 30 eager calls (the wrapper's host time included where
it is longer than the kernel's); beside them the byte bound (each input
read once, each output written once) and, with ``--sass``, the issue
floor.

``--sass`` writes ``cuobjdump -sass`` of every build to ``--out`` and, for
``brute``, prints for the loops of ``closest_kernel`` and ``any_kernel`` that hold a
Moller-Trumbore test, the instructions by class; 27 multiplies are one
test, so ``FMUL / 27`` is the tests one pass of the loop serves.  For
``bounce`` it prints, for ``path_sample_kernel``, ``path_combine_kernel``
and ``brute_shade_kernel``, the instructions of the straight-line path a
lane takes (``sass_path``: no slow path, no rare branch) by class, and
ptxas' registers and spills; the issue floor of an input is its lanes
times that count over the schedulers' rate, 132 SMs x 4 schedulers x 32
lanes an instruction a clock at the SM clock read after its timed
launches.

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


SMS, SCHEDULERS_PER_SM, WARP = 132, 4, 32  # an H100 SXM issues one warp instruction a scheduler a clock
BOUNCE_SOURCES = ("path_bounce.cu", "brute_shade.cu")
BOUNCE_KERNELS = ("path_sample_kernel", "path_combine_kernel", "brute_shade_kernel")
BOUNCE_ITERS = 30
PEAK_BYTES_PER_S = 3.35e12


def issue_floor_ms(lanes: int, instructions: float, sm_clock_mhz: float) -> float:
    """The least time the card's schedulers take to issue ``instructions`` a
    lane for ``lanes`` lanes: one warp instruction a scheduler a clock."""
    return lanes * instructions / (SMS * SCHEDULERS_PER_SM * WARP * sm_clock_mhz * 1e6) * 1e3


def _smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


PSEUDO_FLAGS = ("+fma", "+vote", "+pack35")


def parse_variant(text: str, shipped: str = "brute_trace.cu") -> tuple[str, str, tuple, frozenset]:
    """``label=source[,flag...]`` -> (label, source path, nvcc flags, the
    pseudo-flags given); ``shipped`` names the package's source under csrc/
    ("" for csrc/ itself)."""
    from .cuda_build import CSRC_DIR, NVCC_FLAGS

    label, _, rest = text.partition("=")
    source, *extra = rest.split(",")
    flags = tuple(f for f in NVCC_FLAGS if not (f == "--fmad=false" and "+fma" in extra))
    flags += tuple(f for f in extra if f not in PSEUDO_FLAGS)
    path = os.path.join(CSRC_DIR, shipped) if source == "shipped" else os.path.abspath(source)
    return label, path.rstrip(os.sep), flags, frozenset(f for f in extra if f in PSEUDO_FLAGS)


def sass_functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{function name: [(address, instruction without its ';')]} of a
    ``cuobjdump -sass`` listing; a label line (``.L_x_3:``) is kept as an
    instruction ``.L_x_3:`` at the next address."""
    functions: dict[str, list] = {}
    lines = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            lines = functions.setdefault(ln.split("Function :")[1].strip(), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?);", ln)
        if lines is not None and m:
            lines.append((int(m.group(1), 16), m.group(2).strip()))
        elif lines is not None and re.match(r"^\s*(\.L_\w+):", ln):
            lines.append((-1, ln.strip()))
    for name, lines in functions.items():  # a label takes the address of the instruction after it
        nxt = None
        for k in range(len(lines) - 1, -1, -1):
            if lines[k][0] < 0:
                lines[k] = (nxt, lines[k][1])
            else:
                nxt = lines[k][0]
    return functions


def _op(text: str) -> tuple[str, bool]:
    """(opcode, predicated) of an instruction's text."""
    pred = text.startswith("@")
    body = re.sub(r"^@!?U?P[T\d]+\s+", "", text)
    return body.split()[0], pred or bool(re.match(r"BRA(\.\w+)*\s+!?U?P\d+,", body))


CALL_SITE_OPS = ("MOV", "IMAD.MOV", "CALL", "BRA")  # what nvcc puts around the call of a slow path
RARE_LOOP_MAX = 128  # the longest block with a loop inside that counts as a rare path jumped over


def sass_path(lines: list[tuple[int, str]], trace: list | None = None) -> dict:
    """The straight-line path of one function of a listing (``sass_functions``):
    from its first instruction to an unpredicated EXIT, taking every
    unconditional branch and falling through every conditional one, except a
    forward branch that jumps over a rare path, which is taken: over a call
    site (a block of at most 8 moves, branches and a CALL: nvcc's slow paths
    of division and square root), or over a block of at most RARE_LOOP_MAX
    instructions with a loop inside (the large-argument paths of fmodf and
    of the trigonometric functions, and a block's copy loops, whose one pass
    is left out).  Each instruction counted once, labels not at all.
    Returns the count, the count by class, the function's instructions and
    its CALLs; ``trace`` gets (address, taken) of each conditional branch."""
    code = [(a, t) for a, t in lines if not t.startswith(".L")]
    where = {a: k for k, (a, _t) in enumerate(code)}
    labels = {t[:-1]: a for a, t in lines if t.startswith(".L")}

    def target(text):
        m = re.search(r"`?\(?(0x[0-9a-f]+|\.L_\w+)\)?`?\s*$", text)
        if not m:
            return None
        tok = m.group(1)
        return where.get(int(tok, 16) if tok.startswith("0x") else labels.get(tok))

    def rare(lo, hi):  # the instructions in [lo, hi) are a rare path
        ops = [_op(code[k][1])[0] for k in range(lo, hi)]
        if len(ops) <= 8 and any(op.startswith("CALL") for op in ops) and all(op.startswith(CALL_SITE_OPS)
                                                                                 for op in ops):
            return True
        if hi - lo > RARE_LOOP_MAX:
            return False
        for k in range(lo, hi):
            t = target(code[k][1]) if ops[k - lo].startswith("BRA") else None
            if t is not None and lo <= t <= k:
                return True
        return False

    classes = {cls: 0 for cls, _ in SASS_CLASSES}
    classes["other"] = 0
    seen, k = set(), 0
    while k is not None and k < len(code) and k not in seen:
        seen.add(k)
        text = code[k][1]
        op, pred = _op(text)
        classes[next((cls for cls, pat in SASS_CLASSES if re.match(pat, op)), "other")] += 1
        if op.startswith(("EXIT", "RET")) and not pred:
            break
        if op.startswith("BRA"):
            t = target(text)
            taken = not pred or (t is not None and t > k and rare(k + 1, t))
            if pred and trace is not None:
                trace.append((code[k][0], taken))
            if taken:
                k = t
                continue
        k += 1
    calls = sum(_op(t)[0].startswith("CALL") for _a, t in code)
    return {"instructions": len(seen), "classes": classes, "static_instructions": len(code), "calls": calls}


def cuobjdump_sass(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's, beside nvcc)."""
    from .cuda_build import find_nvcc

    dump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([dump, "-sass", lib_path], capture_output=True, text=True, check=True, timeout=300).stdout


def bounce_paths(sass: str) -> dict[str, dict]:
    """``sass_path`` of each kernel of BOUNCE_KERNELS in a listing."""
    out = {}
    for name, lines in sass_functions(sass).items():
        kernel = next((k for k in BOUNCE_KERNELS if k in name), None)
        if kernel:
            out[kernel] = sass_path(lines)
    return out


def ptxas_usage(log: str) -> dict[str, str]:
    """{kernel: "N registers, ... spill ..."} from a ``-Xptxas -v`` report."""
    usage: dict[str, list] = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
        elif name and ("Used" in ln or "spill" in ln):
            usage.setdefault(name, []).append(ln.split("info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in usage.items()}


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


SWEEP_KERNEL, SWEEP_MULS_PER_BOX = "supercluster_sweep_kernel", 6  # csrc/sc_sweep.cu: 2 FMUL an axis


def sweep_box_instructions(sass: str) -> dict[int, float]:
    """{mode: SASS instructions a box, summed over its passes} of each
    instantiation of K-sweep (``csrc/sc_sweep.cu``, template argument
    ``kMode``) in a ``cuobjdump -sass`` listing.  A pass over the staged
    boxes is an innermost loop (a backward branch whose body holds no other
    one); where nvcc unrolled it, its main body is the one with the most
    FMULs (6 a box) and the remainder loop is left out.  Each pass's count
    is its main body's instructions over the boxes it serves."""
    out = {}
    for name, lines in sass_functions(sass).items():
        m = re.search(SWEEP_KERNEL + r"ILi(\d+)E", name)
        if not m:
            continue
        code = [(a, t) for a, t in lines if a is not None and not t.startswith(".L")]
        labels = {t[:-1]: a for a, t in lines if t.startswith(".L")}
        loops = []
        for addr, text in code:
            t = re.search(r"`?\(?(0x[0-9a-f]+|\.L_\w+)\)?`?\s*$", text)
            if not (_op(text)[0].startswith("BRA") and t):
                continue
            to = int(t.group(1), 16) if t.group(1).startswith("0x") else labels.get(t.group(1))
            if to is not None and to <= addr:
                loops.append((to, addr, [b for a, b in code if to <= a <= addr]))
        inner = [lp for lp in loops if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        muls = [sum(_op(b)[0].startswith("FMUL") for b in body) for _s, _e, body in inner]
        top = max(muls, default=0)
        out[int(m.group(1))] = sum(len(body) * SWEEP_MULS_PER_BOX / n for (_s, _e, body), n in zip(inner, muls)
                                   if n == top and n > 0)
    return out


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


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph (each launch counted nowhere) and the graph replayed between CUDA
    events, so no host time is in it, as in a replayed frame."""
    from .launches import recording

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording(), torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def make_inputs(device) -> list[dict]:
    """The six (scene, batch) inputs with their plain-version results."""
    from ..accel import brute_trace as bt
    from ..engine import RendererType
    from ..engine.camera_kernel import pixel_order
    from ..engine.renderer import Renderer
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


def make_bounce_inputs(device) -> list[dict]:
    """K1's and K3's inputs from one eager Cornell PATH frame, and K3's seeded
    hits at the cap, each with its plain version's result."""
    from ..engine import RendererType, shade
    from ..engine.renderer import Renderer
    from ..integrators import path_kernel as pk
    from ..scene import parse_scene, write_terrain_scene
    from .bench_rays import random_shade_hits, record_bounce_inputs

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    r = Renderer(parse_scene(os.path.join(root, "scenes", "cornell", "scene.json")), width=RES, height=RES,
                 mode=RendererType.PATH, path_depth=4, device=device)
    rec = record_bounce_inputs(r)
    ds = r.device_scene
    frame = f"Cornell PATH {RES}^2"
    inputs = [{"kernel": "K1", "input": f"{frame}, second bounce", "args": (ds, *rec["sample"][1][1:])},
              {"kernel": "K3", "input": f"{frame}, primaries", "args": rec["shade"][0]},
              {"kernel": "K3", "input": f"{frame}, second bounce", "args": rec["shade"][2]}]
    with tempfile.TemporaryDirectory() as tmp:
        cap = parse_scene(write_terrain_scene(tmp, grid=CAP_GRID, width=RES, height=RES))
    cap_ds = Renderer(cap, width=RES, height=RES, mode=RendererType.NORMALS, device=device).device_scene
    inputs.append({"kernel": "K3", "input": f"grid-{CAP_GRID} terrain ({cap_ds.tri_pack.shape[0]} rows), {RAYS} "
                   "seeded hits", "args": (cap_ds, random_shade_hits(cap_ds, RAYS, SEED, device))})
    for inp in inputs:
        if inp["kernel"] == "K1":
            inp["plain"] = pk.path_sample_plain(*inp["args"])
            n, n_lights = inp["args"][2].numel(), inp["args"][0].num_lights
            inp["bytes"] = n * pk.BYTES_SAMPLE + n_lights * pk.BYTES_LIGHT
        else:
            from ..engine import shade_kernel as sk

            ds_i, hit = inp["args"]
            inp["plain"] = shade.build_surface_interaction(ds_i, None, hit)
            n = hit.tri_id.numel()
            inp["bytes"] = n * sk.BYTES_SHADE + torch.unique(hit.tri_id[hit.tri_id >= 0]).numel() * sk.BYTES_ROW
        inp["lanes"] = n
    torch.cuda.synchronize()
    return inputs


def lanes_not_bit_equal(got, want) -> dict:
    """Lanes on which any field of a kernel's dataclass result differs in
    its bits from the plain version's, and each field's such lanes."""
    import dataclasses

    bad, by_field = None, {}
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        diff = g.view(torch.int32) != w.view(torch.int32) if w.dtype == torch.float32 else g != w
        diff = diff.reshape(diff.shape[0], -1).any(dim=1)
        by_field[f.name] = int(diff.sum().item())
        bad = diff if bad is None else bad | diff
    return {"lanes_not_bit_equal": int(bad.sum().item()), "fields_not_bit_equal": by_field}


def bounce_main(args, emit) -> None:
    """``--kernel bounce``: K1 and K3 of every variant against their plain
    versions and each other (see the module's docstring)."""
    from ..engine import shade_kernel as sk
    from ..integrators import path_kernel as pk
    from . import cuda_build

    libs, paths, pack35 = {}, {}, set()
    for text in args.variant or ["shipped=shipped"]:
        label, path, flags, pseudo = parse_variant(text, "")
        if "+pack35" in pseudo:
            pack35.add(label)
        built = {src: cuda_build.build_library(f"{src[:-3]}_{label}", [os.path.join(path, src)], flags)[0]
                 for src in BOUNCE_SOURCES}
        usage = {}
        for lib_path in built.values():
            with open(lib_path + ".log") as f:
                usage.update(ptxas_usage(f.read()))
        emit({"variant": label, "source": os.path.relpath(path),
              "flags": [f for f in flags if f not in cuda_build.NVCC_FLAGS], "fmad_false": "--fmad=false" in flags,
              "ptxas": usage})
        libs[label] = (pk.bind_library(ctypes.CDLL(built["path_bounce.cu"])),
                       sk.bind_library(ctypes.CDLL(built["brute_shade.cu"])))
        if args.sass:
            for src, lib_path in built.items():
                sass = cuobjdump_sass(lib_path)
                with open(os.path.join(args.out, f"{label}_{src[:-3]}.sass"), "w") as f:
                    f.write(sass)
                for kernel, path in bounce_paths(sass).items():
                    paths[label, kernel] = path
                    emit({"variant": label, "kernel": kernel, **path,
                          "ptxas": next((v for k, v in usage.items() if kernel in k), None)})

    padded_pack = sk.padded_pack

    def run(label, inp):
        pk._lib, sk._lib = libs[label]  # the wrappers launch whichever builds are bound
        if inp["kernel"] == "K1":
            return pk.path_sample_cuda(*inp["args"])
        sk.padded_pack = (lambda t: t) if label in pack35 else padded_pack
        try:
            return sk.brute_shade_cuda(*inp["args"])
        finally:
            sk.padded_pack = padded_pack

    for inp in make_bounce_inputs(torch.device("cuda", 0)):
        diffs = {label: lanes_not_bit_equal(run(label, inp), inp["plain"]) for label in libs}
        torch.cuda.synchronize()
        times = {label: [] for label in libs}
        eager = {label: [] for label in libs}
        for _ in range(args.rounds):
            for label in (*libs, *reversed(libs)):
                times[label].append(graph_ms(lambda: run(label, inp), BOUNCE_ITERS))
                eager[label].append(_time_ms(lambda: run(label, inp), BOUNCE_ITERS))
        clock = _smi("clocks.sm")  # read straight after the timed launches
        mhz = float(clock.split()[0])
        kernel = "path_sample_kernel" if inp["kernel"] == "K1" else "brute_shade_kernel"
        for label, ms in times.items():
            path = paths.get((label, kernel))
            emit({"kernel": inp["kernel"], "input": inp["input"], "variant": label, "lanes": inp["lanes"],
                  "ms": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
                  "ms_eager": sum(eager[label]) / len(eager[label]), "ms_eager_min": min(eager[label]),
                  "ms_eager_max": max(eager[label]), "sm_clock_after": clock,
                  **diffs[label], "bound_ms": inp["bytes"] / PEAK_BYTES_PER_S * 1e3,
                  "bound_by": "bytes", "sass_instructions": path and path["instructions"],
                  "issue_floor_ms": path and issue_floor_ms(inp["lanes"], path["instructions"], mhz)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("brute", "ltc", "bounce"), default="brute")
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

    if args.kernel == "bounce":
        bounce_main(args, emit)
        results.write(smi + "\n")
        results.close()
        print(smi)
        return 0

    libs, votes = {}, {}
    for text in args.variant or ["shipped=shipped"]:
        label, path, flags, pseudo = parse_variant(text, shipped)
        vote = votes[label] = "+vote" in pseudo
        lib_path, _ = cuda_build.build_library(f"{shipped[:-3]}_{label}", [path], flags)
        with open(lib_path + ".log") as f:
            usage = [ln.split("info    :")[-1].strip() for ln in f if "Used" in ln or "spill" in ln]
        emit({"variant": label, "source": os.path.relpath(path),
              "flags": [f for f in flags if f not in cuda_build.NVCC_FLAGS], "fmad_false": "--fmad=false" in flags,
              **({} if ltc else {"b1_votes": vote}), "ptxas": usage})
        libs[label] = mod.bind_library(ctypes.CDLL(lib_path))
        if args.sass:
            sass = cuobjdump_sass(lib_path)
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
