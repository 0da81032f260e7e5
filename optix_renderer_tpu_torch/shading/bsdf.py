"""Frostbite-style GGX BSDF, batched over the local shading frame
(counterpart of ``optix_renderer_tpu/shading/bsdf.py``; reference
cuda_include/frostbite.cuh).

Every function takes (..., 3) local-frame directions (+z = shading normal)
and returns masked values instead of early-outs.  The G2 threshold is the
standard height-correlated Smith form, with G1's ``tan2 > 1e5`` cutoff.
"""

from __future__ import annotations

import torch

from ..core import math as cm

EPS = 1e-5  # frostbite.cuh:8


def cos_theta(w):
    return w[..., 2]


def cos_theta2(w):
    return w[..., 2] * w[..., 2]


def sin_theta2(w):
    return torch.clamp(1.0 - cos_theta2(w), min=0.0)


def tan_theta2(w):
    c2 = cos_theta2(w)
    return sin_theta2(w) / torch.where(c2 == 0.0, 1e-30, c2)


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def fr_schlick(cos_theta_i, f0):
    """Schlick Fresnel (frostbite.cuh:36-41); f0 (..., 3)."""
    a = torch.clamp(1.0 - cos_theta_i, min=0.0)
    a5 = (a * a) * (a * a) * a
    return f0 + (1.0 - f0) * a5[..., None]


def d_ggx(wh, alpha):
    """GGX NDF (frostbite.cuh:43-47)."""
    alpha2 = alpha * alpha
    a = 1.0 + cos_theta2(wh) * (alpha2 - 1.0)
    return alpha2 / (cm.PI * a * a)


def _lambda_smith(w, alpha):
    return (-1.0 + cm.sqrt_rn(alpha * alpha * tan_theta2(w) + 1.0)) / 2.0


def g1_smith_ggx(w, alpha):
    """Smith masking (frostbite.cuh:49-56), with the tan2 > 1e5 cutoff."""
    t2 = tan_theta2(w)
    g = 1.0 / (1.0 + _lambda_smith(w, alpha))
    return torch.where(t2 > 1e5, 0.0, g)


def g2_smith_height_correlated_ggx(wi, wo, alpha):
    """Height-correlated Smith G2: 1 / (1 + lambda_wo + lambda_wi), zero
    only at grazing (tan2 > 1e5)."""
    t2o = tan_theta2(wo)
    t2i = tan_theta2(wi)
    g = 1.0 / (1.0 + _lambda_smith(wo, alpha) + _lambda_smith(wi, alpha))
    return torch.where((t2o > 1e5) | (t2i > 1e5), 0.0, g)


def diffuse_lambert(wi, wo, diffuse_color):
    """frostbite.cuh:80-86."""
    val = diffuse_color / cm.PI
    return torch.where(same_hemisphere(wi, wo)[..., None], val, 0.0)


def microfacet_reflection_ggx(wi, wo, f0, alpha):
    """GGX reflection lobe (frostbite.cuh:88-113), the eta=0 path the
    material layer calls (Fresnel from |dot(wi, wh)|)."""
    wh = wi + wo
    wh_len2 = wh[..., 0] * wh[..., 0] + wh[..., 1] * wh[..., 1] + wh[..., 2] * wh[..., 2]
    valid = (
        same_hemisphere(wi, wo)
        & (cos_theta(wi) != 0.0)
        & (cos_theta(wo) != 0.0)
        & (wh_len2 > 0.0)
    )
    wh = wh / cm.sqrt_rn(torch.where(wh_len2 > 0.0, wh_len2, 1.0))[..., None]

    cos_t = cm.dot(wi, wh)  # eta < 1 branch (frostbite.cuh:101-105)
    f = torch.where((cos_t * cos_t > 0.0)[..., None], fr_schlick(torch.abs(cos_t), f0), 1.0)
    g = g2_smith_height_correlated_ggx(wi, wo, alpha)
    d = d_ggx(wh, alpha)
    denom = 4.0 * torch.abs(cos_theta(wi)) * torch.abs(cos_theta(wo))
    val = f * (g * d / torch.where(denom == 0.0, 1.0, denom))[..., None]
    return torch.where(valid[..., None], val, 0.0)


def sample_cosine_hemisphere(u1, u2):
    """frostbite.cuh:160-165 (not the concentric variant in utils.cuh)."""
    ct = cm.sqrt_rn(torch.clamp(1.0 - u1, min=0.0))
    st = cm.sqrt_rn(u1)
    phi = 2.0 * cm.PI * u2
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def pdf_cosine_hemisphere(wi, wo):
    """frostbite.cuh:167-169."""
    return torch.where(same_hemisphere(wi, wo), cos_theta(wi) / cm.PI, 0.0)


def sample_ggx_vndf(wo, alpha, u1, u2):
    """Heitz 2018 visible-NDF sampling (frostbite.cuh:208-232); wo must be
    in the upper hemisphere."""
    a = alpha[..., None]
    wo_hemi = cm.normalize(torch.cat([a * wo[..., :2], wo[..., 2:3]], dim=-1), eps=1e-30)
    length2 = wo_hemi[..., 0] ** 2 + wo_hemi[..., 1] ** 2
    inv_len = 1.0 / cm.sqrt_rn(torch.where(length2 > 0.0, length2, 1.0))
    b1_reg = torch.stack([-wo_hemi[..., 1] * inv_len, wo_hemi[..., 0] * inv_len, torch.zeros_like(inv_len)], dim=-1)
    b1 = torch.where((length2 > 0.0)[..., None], b1_reg, cm.axis_vector(0, 1.0, wo))
    b2 = cm.cross(wo_hemi, b1)

    r = cm.sqrt_rn(u1)
    phi = 2.0 * cm.PI * u2
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + wo_hemi[..., 2])
    t2 = (1.0 - s) * cm.sqrt_rn(torch.clamp(1.0 - t1 * t1, min=0.0)) + s * t2

    wh_hemi = (
        t1[..., None] * b1
        + t2[..., None] * b2
        + cm.sqrt_rn(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))[..., None] * wo_hemi
    )
    wh = torch.cat([a * wh_hemi[..., :2], torch.clamp(wh_hemi[..., 2:3], min=0.0)], dim=-1)
    return cm.normalize(wh, eps=1e-30)


def pdf_ggx_vndf_reflection(wi, wo, alpha):
    """frostbite.cuh:234-243."""
    wh = cm.normalize(wi + wo, eps=1e-30)
    cos_wo = torch.abs(cos_theta(wo))
    pdf_h = g1_smith_ggx(wo, alpha) * d_ggx(wh, alpha) * torch.abs(cm.dot(wh, wo))
    pdf_h = pdf_h / torch.where(cos_wo == 0.0, 1.0, cos_wo)
    dwi = cm.dot(wi, wh)
    dwh_dwi = 1.0 / torch.where(dwi == 0.0, 1e-30, 4.0 * dwi)
    return torch.where(same_hemisphere(wi, wo), pdf_h * dwh_dwi, 0.0)
