"""Vectorized device math: the subset of ``optix_renderer_tpu/core/math.py``
that the port's modes use.

Same conventions: a "vec3 batch" has shape ``(..., 3)``; a 3x3 frame is
row-major ``(..., 3, 3)`` with row ``i`` = basis vector ``i``.  All math is
float32.  Dot products and matrix applications are written as explicit
multiply-adds in a fixed order ((x + y) + z), so no matmul -- and no TF32
-- ever touches the render path, and CPU and CUDA sum in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265358979323846  # include/common.h:4, used as fp32
EPS = 1e-5  # cuda_include/frostbite.cuh:8

_CONSTANTS: dict = {}


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 dot product -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(torch.clamp(dot(a, a), min=0.0))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize along the last axis.

    With ``eps == 0`` this is CUDA ``normalize`` (a * 1/sqrt(dot)), which
    gives inf/nan for zero vectors like the reference.  With ``eps > 0`` a
    vector whose squared length is not above eps is returned unchanged
    (divided by 1), for batches whose degenerate lanes are masked later.
    """
    n2 = dot(a, a)
    if eps > 0.0:
        inv = torch.where(n2 > eps, sqrt_rn(torch.clamp(n2, min=1e-38)), 1.0)
        return a / inv[..., None]
    return a * (1.0 / sqrt_rn(n2))[..., None]


def apply_mat(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-dot matrix application: result_i = dot(mat[i], v)
    (cuda_include/utils.cuh:69-74).  mat (..., 3, 3), v (..., 3)."""
    return torch.stack([dot(mat[..., 0, :], v), dot(mat[..., 1, :], v), dot(mat[..., 2, :], v)], dim=-1)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest, as the card's IEEE ``sqrtf`` and XLA
    give it.  torch's float32 sqrt on the CPU comes from a vector library
    and can be 1 ulp off; the float64 root of a float32 rounds back to the
    nearest float32 exactly.  Every float32 square root of the port goes
    through it, so that the CPU path rounds as the card and the JAX
    package do, and the plain versions repeat the kernels' rounding."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def axis_vector(i: int, value: float, like: torch.Tensor) -> torch.Tensor:
    """(3,) vector with ``value`` at index ``i`` on ``like``'s device and
    dtype, filled on the device: a tensor made from a Python list is a
    host-to-device copy, which synchronizes the host with the card."""
    v = like.new_zeros(3)
    v.narrow(0, i, 1).fill_(value)  # a fill kernel; ``v[i] = value`` copies a host scalar
    return v


def device_constant(name: str, array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module's numpy constant table on ``device``, uploaded once per
    device.  On a card the upload is an asynchronous copy from pinned
    memory, so even the first use does not make the host wait."""
    key = (name, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        _CONSTANTS[key] = t
    return t


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Build (to_local, to_world) frames from normals (utils.cuh:167-190):
    rows of ``to_local`` are (c1, c2, n), singular case at n.z < -0.999999;
    ``to_world`` is the transpose."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.999999
    # regular branch (guard the denominator so the untaken lane stays finite)
    a = 1.0 / torch.where(singular, 1.0, 1.0 + nz)
    b = -nx * ny * a
    c1 = normalize(torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1), eps=1e-30)
    c2 = normalize(torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1), eps=1e-30)
    c1 = torch.where(singular[..., None], axis_vector(1, -1.0, c1), c1)
    c2 = torch.where(singular[..., None], axis_vector(0, -1.0, c2), c2)
    to_local = torch.stack([c1, c2, n], dim=-2)
    return to_local, to_local.transpose(-1, -2)


def sample_point_on_triangle(v1, v2, v3, u1, u2) -> torch.Tensor:
    """sqrt-warp uniform triangle sampling (cuda_include/utils.cuh:193-199)."""
    su1 = sqrt_rn(u1)[..., None]
    u2e = u2[..., None]
    return (1.0 - su1) * v1 + su1 * ((1.0 - u2e) * v2 + u2e * v3)


def matrix_inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) 3x3 inverse, batched, in the JAX package's
    order of operations (it replaces the reference's Gauss-Jordan loop,
    cuda_include/utils.cuh:76-138)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    row0 = torch.stack([co00, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([co01, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([co02, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def spherical_theta(p: torch.Tensor) -> torch.Tensor:
    """acos(z) (cuda_include/utils.cuh:201-204)."""
    return torch.acos(torch.clamp(p[..., 2], -1.0, 1.0))


def balance_heuristic(nf: float, f_pdf: torch.Tensor, ng: float, g_pdf: torch.Tensor) -> torch.Tensor:
    """MIS balance heuristic (cuda_include/utils.cuh:206-209)."""
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def check_positive(v: torch.Tensor) -> torch.Tensor:
    """Clamp components to >= 0 (cuda_include/utils.cuh:218-226)."""
    return torch.clamp(v, min=0.0)


def triangle_area(v1, v2, v3) -> torch.Tensor:
    """0.5 * |cross(v1-v2, v3-v2)| (cuda_include/hit_miss.cuh:24-27)."""
    return 0.5 * length(cross(v1 - v2, v3 - v2))
