"""Branchless polygon clipping to the upper hemisphere (z >= 0).

Counterpart of ``optix_renderer_tpu/shading/polygon_clip.py`` (reference
``clipPolygon``, cuda_include/ltc/polygon_utils.cuh:33-120): the
(vertex_count, per-vertex z > 0) bitmask selects one of 23 cases, and each
case's final vertex values are resolved statically into a dense 128-row
table (the reference's in-place assignment sequences unrolled, including
the ones that read an already-overwritten slot, e.g. case 51's
``v[4] = v[0]`` after ``v[0] = iz0(v0, v1)``).  Each lane fetches its case
row with plain index gathers of the int tables; the JAX package fetches it
with a one-hot matmul, which returns the same integers.

Output contract of the reference: vertex count in {0, 3, 4, 5}; for
vc < 5 the first output vertex is repeated at index vc; untouched slots
pass the input through.  This is the plain PyTorch clip of the LTC
pipeline; kernel B6 (``csrc/ltc.cu``) resolves the same table into
per-case selects.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as cm

# per-output-slot op: COPY input[a]  or  IZ0(input[a], input[b])
_COPY, _IZ0 = 0, 1


def _case(vc, *slots):
    """slots: five (op, a, b) entries (b ignored for COPY)."""
    return vc, slots


def _c(a):  # copy input slot a
    return (_COPY, a, 0)


def _z(a, b):  # iz0(input a, input b)
    return (_IZ0, a, b)


def _keep(i):  # slot keeps its input value
    return (_COPY, i, 0)


# Transcription of polygon_utils.cuh:46-118 with assignment order resolved
# (the JAX package's table, entry for entry).
_CASES = {
    # --- triangles (vertex_count == 3, bits 3..5 = z0,z1,z2 > 0) ---
    3: _case(0, _keep(0), _keep(1), _keep(2), _keep(3), _keep(4)),
    59: _case(3, _c(0), _c(1), _c(2), _c(0), _keep(4)),
    11: _case(3, _c(0), _z(0, 1), _z(2, 0), _c(0), _keep(4)),
    19: _case(3, _z(0, 1), _c(1), _z(1, 2), _z(0, 1), _keep(4)),  # v[3]=v[0] reads new v0
    35: _case(3, _z(2, 0), _z(1, 2), _c(2), _z(2, 0), _keep(4)),
    27: _case(4, _c(0), _c(1), _z(1, 2), _z(2, 0), _c(0)),
    51: _case(4, _z(0, 1), _c(1), _c(2), _z(2, 0), _z(0, 1)),  # v[4]=v[0] reads new v0
    43: _case(4, _c(0), _z(0, 1), _z(1, 2), _c(2), _c(0)),
    # --- quads (vertex_count == 4, bits 3..6 = z0..z3 > 0) ---
    4: _case(0, _keep(0), _keep(1), _keep(2), _keep(3), _keep(4)),
    124: _case(4, _c(0), _c(1), _c(2), _c(3), _c(0)),
    12: _case(3, _c(0), _z(0, 1), _z(3, 0), _c(0), _keep(4)),
    20: _case(3, _z(0, 1), _c(1), _z(1, 2), _z(0, 1), _keep(4)),
    36: _case(3, _z(2, 3), _z(1, 2), _c(2), _z(2, 3), _keep(4)),
    68: _case(3, _c(3), _z(3, 0), _z(2, 3), _c(3), _keep(4)),  # v[3] untouched == v3 == out0
    28: _case(4, _c(0), _c(1), _z(1, 2), _z(3, 0), _c(0)),
    52: _case(4, _z(0, 1), _c(1), _c(2), _z(2, 3), _z(0, 1)),
    100: _case(4, _z(3, 0), _z(1, 2), _c(2), _c(3), _z(3, 0)),
    76: _case(4, _c(0), _z(0, 1), _z(2, 3), _c(3), _c(0)),
    60: _case(5, _c(0), _c(1), _c(2), _z(2, 3), _z(3, 0)),
    116: _case(5, _z(0, 1), _c(1), _c(2), _c(3), _z(3, 0)),
    108: _case(5, _z(0, 1), _z(1, 2), _c(2), _c(3), _c(0)),
    92: _case(5, _c(0), _c(1), _z(1, 2), _z(2, 3), _c(3)),
}

VC_TABLE = np.zeros(128, np.int64)
OP_TABLE = np.zeros((128, 5), np.int64)
A_TABLE = np.tile(np.arange(5, dtype=np.int64), (128, 1))  # default: keep slot
B_TABLE = np.zeros((128, 5), np.int64)
for _mask, (_vc, _slots) in _CASES.items():
    VC_TABLE[_mask] = _vc
    for _j, (_op, _a, _b) in enumerate(_slots):
        OP_TABLE[_mask, _j] = _op
        A_TABLE[_mask, _j] = _a
        B_TABLE[_mask, _j] = _b
# one (128, 16) row per case [vc | op*5 | a*5 | b*5]: a single gather per lane
_CASE_TABLE = np.concatenate([VC_TABLE[:, None], OP_TABLE, A_TABLE, B_TABLE], axis=1)


def iz0(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Normalized intersection of segment lhs->rhs with plane z=0
    (polygon_utils.cuh:7-22).  Batched over (..., 3)."""
    x, y = _iz0_c(lhs[..., 0], lhs[..., 1], lhs[..., 2], rhs[..., 0], rhs[..., 1], rhs[..., 2])
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def _iz0_c(lx, ly, lz, rx, ry, rz):
    """Componentwise ``iz0``: z of the result is identically 0."""
    den = lz - rz
    lerp = lz / torch.where(torch.abs(den) < 1e-30, 1.0, den)
    x = lerp * rx + (-lerp * lx + lx)
    y = lerp * ry + (-lerp * ly + ly)
    n = cm.sqrt_rn(torch.clamp(x * x + y * y, min=1e-30))
    return x / n, y / n


def clip_polygon_c(vx, vy, vz, vcount, tri_input: bool = False):
    """Componentwise clip core.

    ``vx``/``vy``/``vz`` are length-5 lists of same-shape batch tensors
    (one per vertex slot).  Returns ``(ox, oy, oz, vc)`` with the same
    list-of-5 structure; contract of :func:`clip_polygon`.
    ``tri_input=True`` asserts slots 3 and 4 equal slot 0 (the reference
    callers' [v1 v2 v3 v1 v1] convention, ltc_utils.cuh:77/100), so a
    slot index is resolved among slots 0..2 only.
    """
    bits = (
        torch.where(vz[0] > 0.0, 8, 0)
        | torch.where(vz[1] > 0.0, 16, 0)
        | torch.where(vz[2] > 0.0, 32, 0)
        | torch.where((vz[3] > 0.0) & (vcount == 4), 64, 0)
    )
    mask = torch.clamp(vcount.to(torch.int64) + bits, 0, 127)
    rows = cm.device_constant("clip_cases", _CASE_TABLE, mask.device)[mask]  # (..., 16)
    vc = rows[..., 0].to(torch.int32)

    def sel5(idx):  # select vertex slot idx (per lane) -> components
        x, y, z = vx[0], vy[0], vz[0]
        for k in range(1, 3 if tri_input else 5):
            m = idx == k
            x = torch.where(m, vx[k], x)
            y = torch.where(m, vy[k], y)
            z = torch.where(m, vz[k], z)
        return x, y, z

    ox, oy, oz = [], [], []
    for o in range(5):
        op, a, b = rows[..., 1 + o], rows[..., 6 + o], rows[..., 11 + o]
        ax, ay, az = sel5(a)
        bx, by, bz = sel5(b)
        zx, zy = _iz0_c(ax, ay, az, bx, by, bz)
        is_iz = op == _IZ0
        ox.append(torch.where(is_iz, zx, ax))
        oy.append(torch.where(is_iz, zy, ay))
        oz.append(torch.where(is_iz, 0.0, az))
    return ox, oy, oz, vc


def clip_polygon(verts: torch.Tensor, vcount: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Clip polygons to z >= 0.

    verts: (..., 5, 3) with verts[vcount..] = verts[0] for inputs below 5
    vertices (as the reference's callers arrange, ltc_utils.cuh:77/100).
    vcount: (...,) int32 in {0, 3, 4}.  Returns (clipped (..., 5, 3),
    new_count (...,) int32); a pack/unpack wrapper over
    :func:`clip_polygon_c`.
    """
    vx = [verts[..., j, 0] for j in range(5)]
    vy = [verts[..., j, 1] for j in range(5)]
    vz = [verts[..., j, 2] for j in range(5)]
    ox, oy, oz, vc = clip_polygon_c(vx, vy, vz, vcount)
    out = torch.stack([torch.stack([ox[j], oy[j], oz[j]], dim=-1) for j in range(5)], dim=-2)
    return out, vc
