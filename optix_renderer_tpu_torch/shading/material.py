"""Material layer: lobe dispatch over Lambert diffuse + GGX specular
(counterpart of ``optix_renderer_tpu/shading/material.py``; reference
cuda_include/material.cuh in its intended form: probability-weighted lobe
selection, mirror reflection about wh, f0 = base color, 0.5/0.5 lobe
weights, ``evaluate`` with alpha^2 and sampling/pdf with raw alpha).
"""

from __future__ import annotations

import torch

from ..core import math as cm
from . import bsdf

EPS = bsdf.EPS


def evaluate(wi, wo, base_color, alpha):
    """BRDF value (material.cuh:6-22): 0.5*Lambert + 0.5*GGX(alpha^2, f0=base)."""
    alpha2 = alpha * alpha
    diffuse = bsdf.diffuse_lambert(wi, wo, base_color)
    specular = bsdf.microfacet_reflection_ggx(wi, wo, base_color, alpha2)
    return 0.5 * diffuse + 0.5 * specular


def compute_lobe_probabilities(wo, base_color):
    """material.cuh:25-41 (with f0 = base_color this yields (1/3, 2/3))."""
    max_base = base_color.amax(dim=-1)
    p_diffuse = max_base * 0.5
    p_specular = max_base
    norm = 1.0 / torch.where(p_diffuse + p_specular == 0.0, 1.0, p_diffuse + p_specular)
    return p_diffuse * norm, p_specular * norm


def _remap(value, low1, high1, low2, high2):
    """material.cuh:43-47."""
    den = high1 - low1  # high1 is a per-lane tensor in every call
    remapped = low2 + (value - low1) * (high2 - low2) / torch.where(den == 0.0, 1.0, den)
    return torch.clamp(remapped, low2, high2)


def sample_direction(wo, u1, u2, base_color, alpha):
    """Sample wi in the local frame (material.cuh:49-91, intended form).

    Returns (wi (..., 3), pdf (...,), valid (...,)); invalid lanes (the
    reference's ``return vec3(0)`` early-outs) have valid=False.
    """
    p_diffuse, p_specular = compute_lobe_probabilities(wo, base_color)
    # sign(0) would be 0: guard cos == 0 to +1
    sign = torch.sign(torch.where(bsdf.cos_theta(wo) == 0.0, 1.0, bsdf.cos_theta(wo)))

    pick_diffuse = u1 < p_diffuse

    # diffuse branch (material.cuh:58-65)
    u1_d = _remap(u1, 0.0, p_diffuse - EPS, 0.0, 1.0 - EPS)
    wi_d = sign[..., None] * bsdf.sample_cosine_hemisphere(u1_d, u2)
    wi_d = cm.normalize(wi_d, eps=1e-30)

    # specular branch (material.cuh:66-84): VNDF in the upper hemisphere
    u1_s = _remap(u1, p_diffuse, p_diffuse + p_specular - EPS, 0.0, 1.0 - EPS)
    wo_upper = sign[..., None] * wo
    wh = sign[..., None] * bsdf.sample_ggx_vndf(wo_upper, alpha, u1_s, u2)
    dot_wo_wh = cm.dot(wo, wh)
    # mirror reflection: wi = 2 dot(wh, wo) wh - wo
    wi_s = 2.0 * dot_wo_wh[..., None] * wh - wo
    spec_valid = (dot_wo_wh >= 0.0) & bsdf.same_hemisphere(wi_s, wo)

    wi = torch.where(pick_diffuse[..., None], wi_d, wi_s)
    valid = pick_diffuse | spec_valid

    p = p_diffuse * bsdf.pdf_cosine_hemisphere(wi, wo) + p_specular * bsdf.pdf_ggx_vndf_reflection(wi, wo, alpha)
    return wi, p, valid


def pdf(wi, wo, base_color, alpha):
    """Combined lobe pdf (material.cuh:93-104)."""
    p_diffuse, p_specular = compute_lobe_probabilities(wo, base_color)
    return p_diffuse * bsdf.pdf_cosine_hemisphere(wi, wo) + p_specular * bsdf.pdf_ggx_vndf_reflection(wi, wo, alpha)
