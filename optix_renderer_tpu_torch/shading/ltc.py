"""LTC analytic area-light integration (counterpart of
``optix_renderer_tpu/shading/ltc.py``; reference cuda_include/ltc/ltc_utils.cuh).

The per-ray setup of ``ltcDirectLighingBaseline`` (deviceCode.cu:27-48) as
batched tensor functions: :func:`shading_frame`, :func:`fetch_ltc_mat`,
:func:`iso_frame_from_wo_local` and :func:`fused_frames`, which folds each
ray's frame chain into two 3x3 matrices.  ``ltc_kernel.ltc_direct_plain``
composes them with the per-light loop; kernel B6 (``csrc/ltc.cu``) does
the same work in one launch on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .ltc_tables import LTC_ISO_1, LTC_ISO_2, LTC_ISO_3

from ..core import math as cm

# the three 8x8 RGBA LUTs as one (64, 12) table: one gather per bilinear corner
_LTC_PACKED = np.concatenate(
    [np.asarray(LTC_ISO_1).reshape(64, 4),
     np.asarray(LTC_ISO_2).reshape(64, 4),
     np.asarray(LTC_ISO_3).reshape(64, 4)],
    axis=1,
).astype(np.float32)


def _bilinear_8x8_packed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CUDA tex2D LINEAR+CLAMP over the three packed LUTs at once
    (viewer.hpp:322-327 semantics; texel centers at (i + 0.5) / 8).
    Returns (..., 12) = rows of LTC1|LTC2|LTC3."""
    lut = cm.device_constant("ltc_packed", _LTC_PACKED, x.device)
    fx = x * 8.0 - 0.5
    fy = y * 8.0 - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    xi0, xi1 = torch.clamp(xi, 0, 7), torch.clamp(xi + 1, 0, 7)
    yi0, yi1 = torch.clamp(yi, 0, 7), torch.clamp(yi + 1, 0, 7)
    t00 = lut[yi0 * 8 + xi0]
    t01 = lut[yi0 * 8 + xi1]
    t10 = lut[yi1 * 8 + xi0]
    t11 = lut[yi1 * 8 + xi1]
    return (t00 * (1 - tx) + t01 * tx) * (1 - ty) + (t10 * (1 - tx) + t11 * tx) * ty


def fetch_ltc_mat(alpha: torch.Tensor, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ltc_mat (..., 3, 3) row-major, amplitude (...,)) -- ltc_utils.cuh:10-23."""
    x = theta * (0.99 / (0.5 * cm.PI))
    rows = _bilinear_8x8_packed(x, alpha)
    mat = torch.stack([rows[..., 0:3], rows[..., 4:7], rows[..., 8:11]], dim=-2)
    return mat, rows[..., 11]


def _theta_over_sin_theta(x: torch.Tensor) -> torch.Tensor:
    """theta / sin(theta) of the arc whose cosine is ``x``, by the cubic fit
    of ltc_utils.cuh:26-44."""
    y = torch.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    neg = 0.5 / cm.sqrt_rn(torch.clamp(1.0 - x * x, min=1e-7)) - v
    return torch.where(x > 0.0, v, neg)


def integrate_edge_vec(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Cubic-fit arc integral (ltc_utils.cuh:26-44); batched (..., 3)."""
    return cm.cross(v1, v2) * _theta_over_sin_theta(cm.dot(v1, v2))[..., None]


def _integrate_edge_z(ax, ay, az, bx, by, bz):
    """z-component of ``integrate_edge_vec`` (the only one the polygon
    integral reads), componentwise: cross_z(a, b) * theta/sin(theta)."""
    return (ax * by - ay * bx) * _theta_over_sin_theta(ax * bx + ay * by + az * bz)


def _masked_polygon_integral_c(px, py, pz, vc):
    """|sum of edge integrals| over the first vc slots with wraparound
    (the vc-switch bodies in ltc_utils.cuh:80-123, unrolled and masked)."""
    total = torch.zeros_like(px[0])
    for j in range(5):
        wrap = j == vc - 1
        k = min(j + 1, 4)
        nx = torch.where(wrap, px[0], px[k])
        ny = torch.where(wrap, py[0], py[k])
        nz = torch.where(wrap, pz[0], pz[k])
        contrib = _integrate_edge_z(px[j], py[j], pz[j], nx, ny, nz)
        total = total + torch.where(j < vc, contrib, 0.0)
    return torch.abs(total)


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3, 3) @ (R, 3, 3) as explicit multiply-adds (no matmul, no TF32)."""
    return torch.stack([
        torch.stack([a[:, i, 0] * b[:, 0, k] + a[:, i, 1] * b[:, 1, k] + a[:, i, 2] * b[:, 2, k]
                     for k in range(3)], dim=-1)
        for i in range(3)
    ], dim=-2)


def _norm3c(x, y, z, eps=1e-30):
    """Componentwise ``cm.normalize(..., eps)`` -> (x, y, z) tuple."""
    n2 = x * x + y * y + z * z
    inv = torch.where(n2 > eps, cm.sqrt_rn(torch.clamp(n2, min=1e-38)), 1.0)
    return x / inv, y / inv, z / inv


def fused_frames(iso_frame: torch.Tensor, to_local: torch.Tensor,
                 ltc_mat_inv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mat_a, mat_b), row-major (R, 9) each: mat_a = iso @ to_local and
    mat_b = ltc_inv @ mat_a, the two frames of kernel B6's clips.

    The reference chains to_local -> normalize -> iso -> normalize (->
    ltc_inv -> normalize); normalize is scale-invariant under a matrix, so
    one fused matrix per clip input replaces each chain, with a single
    normalize at the end (``ltc.py:178-185`` of the JAX package).
    """
    R = to_local.shape[0]
    mat_a = _matmul33(iso_frame, to_local)
    mat_b = _matmul33(ltc_mat_inv, mat_a)
    return mat_a.reshape(R, 9), mat_b.reshape(R, 9)


def shading_frame(origin: torch.Tensor, p: torch.Tensor, n_geom: torch.Tensor):
    """(to_local (N, 3, 3), wo_local (N, 3)): the hit's local frame and the
    direction back to the ray origin in it (deviceCode.cu:80)."""
    wo = cm.normalize(origin - p, eps=1e-30)
    to_local, _ = cm.orthonormal_basis(n_geom)
    return to_local, cm.normalize(cm.apply_mat(to_local, wo), eps=1e-30)


def iso_frame_from_wo_local(wo_local: torch.Tensor) -> torch.Tensor:
    """Isotropic frame aligning wo into the xz-plane (deviceCode.cu:42-48).

    Rows: [normalize(wo.xy, 0), normalize(cross(z, row0)), z].  A head-on
    view (wo.xy ~ 0) falls back to the x axis, as the JAX package does.
    The constant rows are device fills (``cm.axis_vector``), not copies of
    host lists, so building the frame never makes the host wait.
    """
    xy = wo_local[..., :2]
    n2 = (xy * xy).sum(dim=-1, keepdim=True)
    safe = n2 > 1e-24
    x_axis = cm.axis_vector(0, 1.0, wo_local)[:2]
    r0xy = torch.where(safe, xy / cm.sqrt_rn(torch.where(safe, n2, 1.0)), x_axis)
    row0 = torch.cat([r0xy, torch.zeros_like(r0xy[..., :1])], dim=-1)
    row2 = cm.axis_vector(2, 1.0, wo_local).expand(row0.shape)
    row1 = cm.normalize(cm.cross(row2, row0), eps=1e-30)
    return torch.stack([row0, row1, row2], dim=-2)
