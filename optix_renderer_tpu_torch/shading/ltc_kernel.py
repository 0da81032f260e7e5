"""LTC kernel B6: per hit, the LTC radiance summed over all triangle lights,
from the hit itself (its frame, LUT fetch and matrices included).

Counterpart of ``optix_renderer_tpu/shading/ltc_pallas.py`` together with
the per-ray setup that the JAX package leaves to XLA
(``integrators/ltc_direct.py:19-31``).  Three pieces:

* the wrapper ``ltc_direct_cuda``, which checks its inputs, allocates the
  (R, 3) output and launches the hand-written CUDA kernel in
  ``csrc/ltc.cu`` on the current stream, counting each launch in
  ``LAUNCHES``;
* the plain PyTorch version ``ltc_direct_plain``: the port's setup
  functions (``shading.ltc``, ``core.math``) in the JAX package's order,
  then ``ltc_integrate_plain``, then ``where(upper, ..., 0)``;
* ``ltc_integrate_plain``, the per-light loop from the fused operands: the
  flat (L*R,) pipeline of the JAX package's XLA branch (``ltc.py:202-265``)
  in its order of operations -- translate, the back-face test, the fused
  diffuse frame, the triangle clip, the edge integrals, then the LTC frame
  and the second clip of the ORIGINAL triangle with the first clip's vertex
  count (the reference's own sequence, ltc_utils.cuh:94-101).  Its sum over
  the lights runs in light order, as the kernel's does.

``ltc_direct_ops`` counts the f32 operations that a batch's data needs,
for the kernel's bound, from the plain version's intermediates.

All keep the reference's LTC brightness (no 1/pi, no 0.5 lobe weights).
Inputs of the entries: origin, p, n_geom, diffuse (R, 3); alpha (R,);
lights (L, 16) rows ``[v1 v2 v3 normal emit pad]`` (``pack_lights``;
``light_table`` packs a scene's lights once and reuses the table).  Operands of
``ltc_integrate_plain``: p, diffuse (R, 3); mat_a = iso @ to_local and
mat_b = ltc_inv @ mat_a, row-major (R, 9); amplitude (R,); lights.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import math as cm
from ..utils.launches import count_launch
from . import ltc
from .ltc import _masked_polygon_integral_c, _norm3c
from .polygon_clip import clip_polygon_c

# light row layout of the (L, 16) operand
_L_V1, _L_V2, _L_V3, _L_N, _L_EMIT = 0, 3, 6, 9, 12

# Launches of the kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# version is not counted.
LAUNCHES = {"ltc": 0}

SOURCES = ["ltc.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a build of csrc/ltc.cu (the package's or a
    variant's, ``utils.brute_bench --kernel ltc``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ltc_direct.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr]
    lib.ltc_direct.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("ltc", SOURCES))
    return _lib


def pack_lights(light_v1, light_v2, light_v3, light_normal, light_emit) -> torch.Tensor:
    """(L, 16) kernel operand from the DeviceScene light arrays."""
    pad = light_v1.new_zeros((light_v1.shape[0], 1))
    return torch.cat([light_v1, light_v2, light_v3, light_normal, light_emit, pad], dim=1).contiguous()


_light_table = None  # (the five light tensors, their versions, the table packed from them)


def light_table(light_v1, light_v2, light_v3, light_normal, light_emit) -> torch.Tensor:
    """``pack_lights`` of a scene's light tensors, packed once: the same
    tensors, unchanged since, get the same table back."""
    global _light_table
    src = (light_v1, light_v2, light_v3, light_normal, light_emit)
    versions = tuple(t._version for t in src)
    if _light_table is None or _light_table[1] != versions or any(a is not b for a, b in zip(_light_table[0], src)):
        _light_table = (src, versions, pack_lights(*src))
    return _light_table[2]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _light_pairs(p, mat_a, mat_b, lights) -> dict:
    """The per-(light, ray) part of ltc_integrate_plain, flat (L*R,) and
    light-major: the back-face test and, for each clip, the z of its three
    input corners, its vertex count and its polygon integral."""
    R = p.shape[0]
    L = lights.shape[0]

    def per_ray(v):  # (R,) -> (L*R,), light-major
        return v.repeat(L)

    def per_light(v):  # (L,) -> (L*R,), light-major
        return v.repeat_interleave(R)

    px, py, pz = (per_ray(p[:, a]) for a in range(3))

    def translate(col):  # light corner at lights[:, col:col+3] -> normalized (L*R,) comps
        return _norm3c(per_light(lights[:, col]) - px,
                       per_light(lights[:, col + 1]) - py,
                       per_light(lights[:, col + 2]) - pz)

    l1, l2, l3 = translate(_L_V1), translate(_L_V2), translate(_L_V3)
    cgx, cgy, cgz = _norm3c(l1[0] + l2[0] + l3[0], l1[1] + l2[1] + l3[1], l1[2] + l2[2] + l3[2])
    lnx, lny, lnz = (per_light(lights[:, _L_N + a]) for a in range(3))
    facing = -(cgx * lnx + cgy * lny + cgz * lnz) >= 0.0  # back-face test, ltc_utils.cuh:62-64

    def xform(m, v):  # m: (R, 9) row-major per-ray matrix, v: (L*R,) comps
        x, y, z = v
        mr = lambda k: per_ray(m[:, k])  # noqa: E731
        return _norm3c(mr(0) * x + mr(1) * y + mr(2) * z,
                       mr(3) * x + mr(4) * y + mr(5) * z,
                       mr(6) * x + mr(7) * y + mr(8) * z)

    def slots(a, b, c):
        return [a, b, c, a, a]

    # first clip: the cosine (diffuse) polygon, slots [v1 v2 v3 v1 v1]
    a1, a2, a3 = xform(mat_a, l1), xform(mat_a, l2), xform(mat_a, l3)
    vc0 = torch.full_like(px, 3, dtype=torch.int32)
    dx, dy, dz, dvc = clip_polygon_c(slots(a1[0], a2[0], a3[0]), slots(a1[1], a2[1], a3[1]),
                                     slots(a1[2], a2[2], a3[2]), vc0, tri_input=True)
    diffuse_shading = _masked_polygon_integral_c(dx, dy, dz, dvc)

    # second clip: the LTC-transformed ORIGINAL triangle with the first
    # clip's vertex count (ltc_utils.cuh:94-101)
    t1, t2, t3 = xform(mat_b, l1), xform(mat_b, l2), xform(mat_b, l3)
    gx, gy, gz, gvc = clip_polygon_c(slots(t1[0], t2[0], t3[0]), slots(t1[1], t2[1], t3[1]),
                                     slots(t1[2], t2[2], t3[2]), dvc, tri_input=True)
    ggx_shading = _masked_polygon_integral_c(gx, gy, gz, gvc)
    return {"facing": facing, "a_z": (a1[2], a2[2], a3[2]), "dvc": dvc, "d": diffuse_shading,
            "t_z": (t1[2], t2[2], t3[2]), "gvc": gvc, "g": ggx_shading}


def ltc_integrate_plain(p, diffuse, mat_a, mat_b, amplitude, lights) -> torch.Tensor:
    """Summed LTC radiance over all lights, (R, 3); zeros when L == 0."""
    R = p.shape[0]
    L = lights.shape[0]
    out = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    if L == 0 or R == 0:
        return out
    pairs = _light_pairs(p, mat_a, mat_b, lights)
    d = torch.where(pairs["facing"], pairs["d"], 0.0).reshape(L, R)
    g = torch.where(pairs["facing"], pairs["g"], 0.0).reshape(L, R)
    for ch in range(3):
        for light in range(L):  # in light order, as the kernel accumulates
            term = (diffuse[:, ch] * d[light] + amplitude * g[light]) * lights[light, _L_EMIT + ch]
            out[:, ch] = out[:, ch] + term
    return out


def _fused_operands(origin, p, n_geom, alpha):
    """(upper (R,), mat_a, mat_b (R, 9), amplitude (R,)): the per-ray setup
    (deviceCode.cu:27-48) in the port's order."""
    to_local, wo_local = ltc.shading_frame(origin, p, n_geom)
    upper = wo_local[..., 2] >= 0.0  # :27-28 (z < 0 -> black)
    theta = cm.spherical_theta(wo_local)  # :36
    ltc_mat, amplitude = ltc.fetch_ltc_mat(alpha, theta)  # :38-39
    ltc_mat_inv = cm.matrix_inverse_3x3(ltc_mat)  # :40
    iso = ltc.iso_frame_from_wo_local(wo_local)  # :42-48
    mat_a, mat_b = ltc.fused_frames(iso, to_local, ltc_mat_inv)
    return upper, mat_a, mat_b, amplitude


def ltc_direct_plain(origin, p, n_geom, alpha, diffuse, lights) -> torch.Tensor:
    """LTC radiance of each hit, (R, 3); 0 where the ray origin lies below
    the hit's horizon (deviceCode.cu:27-48, then ltc_utils.cuh:47-127)."""
    upper, mat_a, mat_b, amplitude = _fused_operands(origin, p, n_geom, alpha)
    color = ltc_integrate_plain(p, diffuse, mat_a, mat_b, amplitude, lights)
    return torch.where(upper[:, None], color, 0.0)


# f32 adds, subtracts, multiplies, divisions, square roots, floors and the
# acos of csrc/ltc.cu, counted there piece by piece.  Per ray (setup): the
# frame, which decides upper (wo 12, orthonormal_basis 28, wo_local 24);
# the diffuse frame mat_a (iso frame 24, the product 45); the LTC frame
# mat_b (acos 1, LUT fetch 101, inverse 42, the product 45).  Per ray and
# light (add_light): the three corners and the back-face test (36 + 15 + 5);
# a clip's three corners through its frame (3 x 24); an edge intersection
# (iz0); an edge integral and its add (edge_z 22 + 1); the sum (3 x 5).
OPS_FRAME, OPS_DIFFUSE_FRAME, OPS_LTC_FRAME = 64, 69, 189
OPS_FACING, OPS_CORNERS, OPS_IZ0, OPS_EDGE, OPS_SUM = 56, 72, 16, 23, 15


def ltc_direct_ops(origin, p, n_geom, alpha, diffuse, lights) -> int:
    """The f32 operations (``OPS_*``) that ltc_direct_plain's result needs on
    this data, whatever a kernel runs: the frame of every ray; for an upper
    ray the back-face test of every light, and for each light that faces it
    the first clip's corners, the edge intersections of its edges that cross
    the horizon, its vertex count's edge integrals and the sum; where that
    clip keeps a polygon, the second clip's corners, intersections and edge
    integrals; and once a ray the diffuse frame (some light faces it) and the
    LTC frame (some first clip keeps a polygon)."""
    R, L = p.shape[0], lights.shape[0]
    if R == 0 or L == 0:
        return R * OPS_FRAME
    upper, mat_a, mat_b, _ = _fused_operands(origin, p, n_geom, alpha)
    pairs = _light_pairs(p, mat_a, mat_b, lights)
    live = upper.repeat(L)
    facing = pairs["facing"] & live
    keeps = facing & (pairs["dvc"] > 0)

    def crossings(zs):  # edges s0 s1, s1 s2, s2 s0 whose ends lie on two sides of z = 0
        b = [z > 0.0 for z in zs]
        return (b[0] != b[1]).long() + (b[1] != b[2]).long() + (b[2] != b[0]).long()

    first = OPS_CORNERS + OPS_SUM + OPS_IZ0 * crossings(pairs["a_z"]) + OPS_EDGE * pairs["dvc"].long()
    second = OPS_CORNERS + OPS_IZ0 * crossings(pairs["t_z"]) + OPS_EDGE * pairs["gvc"].long()
    per_pair = (OPS_FACING * live.long() + torch.where(facing, first, 0) + torch.where(keeps, second, 0)).sum()
    per_ray = (OPS_DIFFUSE_FRAME * facing.reshape(L, R).any(dim=0).long().sum()
               + OPS_LTC_FRAME * keeps.reshape(L, R).any(dim=0).long().sum())
    return R * OPS_FRAME + int((per_pair + per_ray).item())


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

def _check_inputs(origin, p, n_geom, alpha, diffuse, lights) -> tuple[int, int]:
    r = p.shape[0] if p.dim() == 2 else -1
    checks = (
        (p.dim() == 2 and p.shape[1] == 3, f"p must be (R, 3), got {tuple(p.shape)}"),
        (tuple(origin.shape) == (r, 3), f"origin must be ({r}, 3), got {tuple(origin.shape)}"),
        (tuple(n_geom.shape) == (r, 3), f"n_geom must be ({r}, 3), got {tuple(n_geom.shape)}"),
        (tuple(alpha.shape) == (r,), f"alpha must be ({r},), got {tuple(alpha.shape)}"),
        (tuple(diffuse.shape) == (r, 3), f"diffuse must be ({r}, 3), got {tuple(diffuse.shape)}"),
        (lights.dim() == 2 and lights.shape[1] == 16, f"lights must be (L, 16), got {tuple(lights.shape)}"),
        (r < 2**31 and lights.shape[0] < 2**31, "more than 2^31 - 1 rays or lights"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    named = (("origin", origin), ("p", p), ("n_geom", n_geom), ("alpha", alpha), ("diffuse", diffuse),
             ("lights", lights))
    for name, a in named:
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
    for name, a in named:
        if a.device.type != "cuda" or a.device != p.device:
            raise ValueError(f"{name} must be on the hits' CUDA device, got {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")
    return r, lights.shape[0]


def ltc_direct_cuda(origin, p, n_geom, alpha, diffuse, lights) -> torch.Tensor:
    """Kernel B6 on the card; same output as ltc_direct_plain."""
    r, n_lights = _check_inputs(origin, p, n_geom, alpha, diffuse, lights)
    if r == 0 or n_lights == 0:  # nothing to sum; a grid of 0 blocks is an invalid launch
        return torch.zeros((r, 3), dtype=torch.float32, device=p.device)
    lut = cm.device_constant("ltc_packed", ltc._LTC_PACKED, p.device)
    out = torch.empty((r, 3), dtype=torch.float32, device=p.device)
    lib = kernel_library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ltc_direct(origin.data_ptr(), p.data_ptr(), n_geom.data_ptr(), alpha.data_ptr(),
                             diffuse.data_ptr(), r, lut.data_ptr(), lights.data_ptr(), n_lights,
                             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ltc_direct launch failed: cudaError {err}")
    count_launch(LAUNCHES, "ltc", "ltc_kernel")
    return out
