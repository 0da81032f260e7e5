"""The plain reference's LTC term: the analytic direct light of every
triangle light at a hit, as the reference renderer's ``ltcDirectLighingBaseline``
(deviceCode.cu:23-56) and ``integrateOverPolygon`` (ltc/ltc_utils.cuh:47-127)
state it, in plain PyTorch, in any float dtype.  It imports nothing of the
renderer under test.  The lookup tables (``ltc_isotropic.json``) are a
transcription of the reference's ``include/ltc/ltc_isotropic.h:4-8`` with
the header's decimals, not data that the renderer prepared:
``tests/test_reference_ltc_tables.py`` holds them equal, decimal for
decimal, to the JAX package's transcription of the same header.

For each hit: the shading frame (utils.cuh:167-190) and the direction back
to the camera in it, black where that lies below the horizon; the LTC
matrix fetched at (alpha, theta) with the texture unit's bilinear filter
and clamping (ltc_utils.cuh:10-23, viewer.hpp:322-331), and its inverse;
the isotropic frame (deviceCode.cu:42-48).  Then, light by light in the
scene's order: the corners moved to the hit and normalized, the back-face
test on their centroid (ltc_utils.cuh:62-64), the corners taken into the
local frame and then the isotropic one, normalized after each, the
triangle clipped to the upper hemisphere and its edge integrals summed
(the cosine term D); the same corners through the inverse LTC matrix,
normalized, clipped again and summed (the GGX term G); the light adds
``(diffuse * D + amplitude * G) * emission``.  Like the renderer, and like
the reference's committed code, no 1/pi and no 0.5 lobe weights.

Where the renderer (``shading/ltc.py``, ``shading/ltc_kernel.py`` of the
port) departs from the reference's code, or keeps one of its quirks, this
does the same:

* the inverse is the closed-form adjugate, where the reference runs a
  Gauss-Jordan loop (utils.cuh:76-138): the same matrix to rounding;
* the second clip takes the first clip's vertex count, as the reference
  does (ltc_utils.cuh:94-101): G is 0 wherever the cosine clip left
  nothing, and the original triangle, clipped, everywhere else (a count of
  4 makes it a quad whose fourth corner repeats the first, which clips to
  the same polygon);
* the renderer folds each chain of frames into one matrix with a single
  normalize (normalize is scale-invariant); this reference keeps the chain,
  so the two agree to rounding;
* a head-on view (the direction's xy below 1e-12 in length) takes the x
  axis as the isotropic frame's first row, as the renderer does.

The clip here is the plain Sutherland-Hodgman clip against z > 0; the
reference's 23-case table gives the same polygon, started at another
corner, and so the same sum of edge integrals to rounding.
"""

from __future__ import annotations

import json
import os

import torch

from .render import PI, apply_mat, cross, dot, normalize, orthonormal_basis, sqrt

_TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ltc_isotropic.json")


def _lut_rows(device, dtype) -> torch.Tensor:
    """(64, 12): texel [row * 8 + column] of the three tables, rgba each."""
    with open(_TABLES) as f:
        t = json.load(f)
    rows = torch.cat([torch.tensor(t[k], dtype=torch.float32).reshape(64, 4) for k in ("ltc1", "ltc2", "ltc3")], dim=1)
    return rows.to(device=device, dtype=dtype)


def fetch_ltc(alpha, theta):
    """(matrix (R, 3, 3) by rows, amplitude (R,)): tex2D with LINEAR
    filtering and CLAMP addressing at x = theta / (pi / 2) * 0.99, y =
    alpha, texel centres at (i + 0.5) / 8."""
    lut = _lut_rows(alpha.device, alpha.dtype)
    fx = theta * (0.99 / (0.5 * PI)) * 8.0 - 0.5
    fy = alpha * 8.0 - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    x_lo, x_hi = xi.clamp(0, 7), (xi + 1).clamp(0, 7)
    y_lo, y_hi = yi.clamp(0, 7), (yi + 1).clamp(0, 7)
    texel = lambda y, x: lut[y * 8 + x]  # noqa: E731
    rows = ((texel(y_lo, x_lo) * (1 - tx) + texel(y_lo, x_hi) * tx) * (1 - ty)
            + (texel(y_hi, x_lo) * (1 - tx) + texel(y_hi, x_hi) * tx) * ty)
    return torch.stack([rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]], dim=1), rows[:, 11]


def inverse3(m):
    """The inverse of each (3, 3) by its adjugate."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + b * c01 + c * c02
    adj = torch.stack([torch.stack([c00, c * h - b * i, b * f - c * e], dim=-1),
                       torch.stack([c01, a * i - c * g, c * d - a * f], dim=-1),
                       torch.stack([c02, b * g - a * h, a * e - b * d], dim=-1)], dim=1)
    return adj / det[:, None, None]


def iso_frame(wo):
    """Rows: wo's xy direction (the x axis for a head-on view), z cross it, z."""
    xy = torch.cat([wo[:, :2], torch.zeros_like(wo[:, :1])], dim=1)
    n2 = dot(xy, xy)
    ok = n2 > 1e-24
    x_axis = torch.zeros_like(xy)
    x_axis[:, 0] = 1.0
    row0 = torch.where(ok[:, None], xy / sqrt(torch.where(ok, n2, 1.0))[:, None], x_axis)
    z = torch.zeros_like(xy)
    z[:, 2] = 1.0
    return torch.stack([row0, normalize(cross(z, row0), eps=1e-30), z], dim=1)


def _theta_over_sin_theta(x):
    """The cubic fit of ltc_utils.cuh:26-44 to acos(x) / sqrt(1 - x^2)."""
    y = torch.abs(x)
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    return torch.where(x > 0.0, v, 0.5 / sqrt(torch.clamp(1.0 - x * x, min=1e-7)) - v)


def _edge_z(a, b):
    """The z of the edge integral of unit vectors a -> b."""
    return (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]) * _theta_over_sin_theta(dot(a, b))


def _horizon_point(a, b):
    """Where the segment a -> b crosses z = 0, as a unit vector (polygon_utils.cuh:7-22)."""
    den = a[:, 2] - b[:, 2]
    s = a[:, 2] / torch.where(den.abs() < 1e-30, 1.0, den)
    x = a[:, 0] + s * (b[:, 0] - a[:, 0])
    y = a[:, 1] + s * (b[:, 1] - a[:, 1])
    n = sqrt(torch.clamp(x * x + y * y, min=1e-30))
    return torch.stack([x / n, y / n, torch.zeros_like(x)], dim=-1)


def clipped_integral(corners):
    """(|sum of edge integrals| of the triangle clipped to z > 0, the
    clipped polygon's corner count): Sutherland-Hodgman, one lane at a
    time in a batch, with every candidate corner kept and masked."""
    inside = [c[:, 2] > 0.0 for c in corners]
    poly, keep = [], []
    for k in range(3):  # a corner if it is inside, then where its edge to the next crosses the horizon
        a, b = corners[k], corners[(k + 1) % 3]
        poly.append(a)
        keep.append(inside[k])
        poly.append(_horizon_point(a, b))
        keep.append(inside[k] != inside[(k + 1) % 3])
    mask = torch.stack(keep, dim=1)  # (R, 6)
    pts = torch.stack(poly, dim=1)  # (R, 6, 3)
    count = mask.sum(dim=1)
    # the kept corners in order, compacted to the front: a stable sort of the dropped ones to the back
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    pts = torch.gather(pts, 1, order[:, :, None].expand(-1, -1, 3))
    total = torch.zeros_like(pts[:, 0, 0])
    for j in range(4):  # at most four corners: one inside gives three, two give four
        nxt = torch.where((count == j + 1)[:, None], pts[:, 0], pts[:, min(j + 1, 5)])
        total = total + torch.where(count > j, _edge_z(pts[:, j], nxt), 0.0)
    return torch.abs(total), count


def ltc_direct(scene, origin, p, n, alpha, diffuse):
    """The LTC radiance (R, 3) at hits (p, n, alpha, diffuse) seen from
    ``origin`` (R, 3), summed over the scene's triangle lights in order."""
    wo = normalize(origin - p, eps=1e-30)
    to_local, _ = orthonormal_basis(n)
    wo_l = normalize(apply_mat(to_local, wo), eps=1e-30)
    upper = wo_l[:, 2] >= 0.0
    theta = torch.acos(torch.clamp(wo_l[:, 2], -1.0, 1.0))
    mat, amplitude = fetch_ltc(alpha, theta)
    inv = inverse3(mat)
    iso = iso_frame(wo_l)
    color = torch.zeros_like(p)
    for light in range(scene.num_lights):
        lv = scene.light_v[light]
        c = [normalize(lv[k][None, :] - p, eps=1e-30) for k in range(3)]
        cg = normalize(c[0] + c[1] + c[2], eps=1e-30)
        facing = -dot(cg, scene.light_normal[light][None, :].expand_as(cg)) >= 0.0
        a = [normalize(apply_mat(iso, normalize(apply_mat(to_local, ck), eps=1e-30)), eps=1e-30) for ck in c]
        d_term, count = clipped_integral(a)
        g_term, _ = clipped_integral([normalize(apply_mat(inv, ak), eps=1e-30) for ak in a])
        g_term = torch.where(count > 0, g_term, 0.0)
        term = diffuse * d_term[:, None] + amplitude[:, None] * g_term[:, None]
        color = color + torch.where(facing[:, None], term, 0.0) * scene.light_emit[light][None, :]
    return torch.where(upper[:, None], color, 0.0)
