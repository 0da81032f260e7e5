"""Multi-bounce path tracer with full MIS (counterpart of
``optix_renderer_tpu/integrators/path.py``; the intended estimator of the
reference's cuda_include/path/path.cuh: next-event estimation + BSDF
sampling combined with the balance heuristic).

The bounce loop is a Python loop over a static depth with an ``alive``
mask: every lane runs the NEE shadow trace and the BSDF bounce trace each
bounce (masked), so shapes stay static.  Compaction is a later layer.
Nothing in the loop reads a value back to the host: the per-bounce counts
stay on the device until ``Renderer.metrics`` drains them.
"""

from __future__ import annotations

import torch

from ..accel.cluster import merge_trace_stats
from ..accel.traverse import trace_any_with_stats, zero_trace_stats
from ..core import math as cm
from ..core import rng as rnglib
from ..core.types import Ray, SurfaceInteraction
from ..engine.shade import trace_closest_si
from ..scene.device import DeviceScene
from ..shading import material
from ..shading.bsdf import EPS, cos_theta

# offset of secondary ray origins along the geometric normal
RAY_EPS = 1e-3


def pdf_area_to_solid_angle(pdf, dist2, cos_t):
    """pdfA2W (path.cuh:24-33)."""
    abs_cos = torch.abs(cos_t)
    small = abs_cos < 1e-8
    return torch.where(small, 0.0, pdf * dist2 / torch.where(small, 1.0, abs_cos))


def _clamp_dot(a, b):
    """clampDot(a, b, zero=false) = max(dot, EPS) (frostbite.cuh:13-16)."""
    return torch.clamp(cm.dot(a, b), min=EPS)


def gather_light_attrs(ds: DeviceScene, lidx: torch.Tensor):
    """Per-lane TriLight attribute fetch (sampleLight, path.cuh:6-14) as
    plain index gathers.  Returns (v1, v2, v3, normal, emit, area)."""
    i = lidx.long()
    return (ds.light_v1[i], ds.light_v2[i], ds.light_v3[i],
            ds.light_normal[i], ds.light_emit[i], ds.light_area[i])


def path_color(ds: DeviceScene, bvh, rays: Ray, si: SurfaceInteraction, rng_state: torch.Tensor,
               max_depth: int = 10):
    """Radiance for each primary ray; returns (color (N, 3), rng_state,
    alive_counts (max_depth, 3) int64 on the device, trace_stats): the
    cluster tier's statistics of every NEE and bounce trace, merged (the
    zero dict on the brute tier).

    On the cluster tier the shadow and bounce rays are incoherent: both
    traces take the per-lane cull, corridor-sorted (JAX path.py with its
    default NEE sort).

    alive_counts columns per bounce: [0] lanes alive, [1] NEE shadow rays
    actually traced (lanes whose contribution is not provably zero), [2]
    bounce closest rays actually traced (valid BSDF samples).

    Outer PATH-mode wrapping (deviceCode.cu:146-153): miss lanes get the
    background, direct light hits raw emission; everything else is the
    path estimate, floored at EPS per channel (path.cuh:254-256).
    """
    n = rays.origin.shape[0]
    num_lights = ds.num_lights
    dev = rays.origin.device

    alive_counts = torch.zeros((max_depth, 3), dtype=torch.int64, device=dev)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = si.hit & ~si.is_light
    p, nrm, diffuse, alpha = si.p, si.n_geom, si.diffuse, si.alpha
    v = cm.normalize(rays.origin - si.p, eps=1e-30)  # back toward the camera
    rng = rng_state
    stats = zero_trace_stats()

    for d in range(max_depth):
        to_local, to_world = cm.orthonormal_basis(nrm)
        wo_local = cm.normalize(cm.apply_mat(to_local, v), eps=1e-30)

        rng, l_u1, l_u2 = rnglib.lcg_randomf2(rng)  # rand1 (path.cuh:165)
        rng, b_u1, b_u2 = rnglib.lcg_randomf2(rng)  # rand2 (path.cuh:166)
        rng, l_pick = rnglib.lcg_randomf(rng)  # light index (path.cuh:169)
        light_idx = torch.clamp((l_pick * num_lights).to(torch.int32), 0, num_lights - 1)

        # ---- NEE / light sampling (path.cuh:176-205, intended) ----------
        lv1, lv2, lv3, lnormal, lemit, larea = gather_light_attrs(ds, light_idx)
        light_pdf_a = 1.0 / (larea * num_lights)
        lp = cm.sample_point_on_triangle(lv1, lv2, lv3, l_u1, l_u2)
        shadow_origin = p + nrm * RAY_EPS
        to_light = lp - shadow_origin
        dist2 = cm.dot(to_light, to_light)
        dist = cm.sqrt_rn(dist2)
        ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]

        light_pdf_w = pdf_area_to_solid_angle(light_pdf_a, dist2, cm.dot(-ldir, lnormal))
        wi_local_nee = cm.normalize(cm.apply_mat(to_local, ldir), eps=1e-30)
        brdf_pdf_nee = material.pdf(wi_local_nee, wo_local, diffuse, alpha)
        brdf_nee = material.evaluate(wi_local_nee, wo_local, diffuse, alpha)
        mis_nee = cm.balance_heuristic(1, light_pdf_w, 1, brdf_pdf_nee)

        # Lanes whose NEE contribution is provably zero (dead, zero light
        # pdf, light sample outside the BSDF hemisphere) trace with
        # t_max = 0: the kernel skips them, and ``occluded`` only feeds
        # nee_ok, which is false for them either way.
        shadow_needed = alive & (light_pdf_w > 0.0) & (brdf_nee != 0.0).any(dim=-1)
        occluded, any_stats = trace_any_with_stats(
            bvh, Ray(origin=shadow_origin, direction=ldir),
            t_max=torch.where(shadow_needed, dist * (1.0 - 1e-3), 0.0), refine=True, coherent=False,
        )
        nee_ok = shadow_needed & ~occluded
        nee = (
            mis_nee[:, None]
            * lemit
            * tp
            * brdf_nee
            * (_clamp_dot(nrm, ldir) / torch.where(light_pdf_w == 0.0, 1.0, light_pdf_w))[:, None]
        )
        color += torch.where(nee_ok[:, None], cm.check_positive(nee), 0.0)  # in place: one (N, 3) sum

        # ---- BSDF sampling (path.cuh:207-245, intended) ------------------
        wi_local, bsdf_pdf, valid = material.sample_direction(wo_local, b_u1, b_u2, diffuse, alpha)
        cos_i = cos_theta(wi_local)
        sample_ok = alive & valid & (bsdf_pdf > 0.0) & (cos_i > 0.0)

        brdf = material.evaluate(wi_local, wo_local, diffuse, alpha)
        dir_world = cm.normalize(cm.apply_mat(to_world, wi_local), eps=1e-30)
        # lanes that cannot contribute (dead, or an invalid BSDF sample) are
        # not traced: their hits are masked by sample_ok below
        bounce_si, closest_stats = trace_closest_si(
            ds, bvh, Ray(origin=p + nrm * RAY_EPS, direction=dir_world), active=sample_ok, coherent=False
        )
        stats = merge_trace_stats(stats, merge_trace_stats(any_stats, closest_stats))

        hit_light = sample_ok & bounce_si.hit & bounce_si.is_light
        dp = bounce_si.p - p
        d2 = cm.dot(dp, dp)
        lpdf_a = 1.0 / (torch.clamp(bounce_si.area, min=1e-20) * num_lights)
        # area -> solid angle with the cosine at the LIGHT surface, as in the
        # NEE arm, so the two strategies' balance weights sum to 1
        lpdf_w = pdf_area_to_solid_angle(lpdf_a, d2, cm.dot(-dir_world, bounce_si.n_geom))
        mis_b = cm.balance_heuristic(1, bsdf_pdf, 1, lpdf_w)
        safe_pdf = torch.where(bsdf_pdf == 0.0, 1.0, bsdf_pdf)
        emit_term = mis_b[:, None] * bounce_si.emit * tp * brdf * (cos_i / safe_pdf)[:, None]
        color += torch.where(hit_light[:, None], cm.check_positive(emit_term), 0.0)

        # ---- advance (path.cuh:240, 249-252 with real alpha) -------------
        continue_path = sample_ok & bounce_si.hit & ~bounce_si.is_light
        new_tp = tp * brdf * (cos_i / safe_pdf)[:, None]
        c = continue_path[:, None]
        alive_counts[d] = torch.stack([alive.sum(), shadow_needed.sum(), sample_ok.sum()])
        tp = torch.where(c, new_tp, tp)
        alive = continue_path
        p = torch.where(c, bounce_si.p, p)
        nrm = torch.where(c, bounce_si.n_geom, nrm)
        diffuse = torch.where(c, bounce_si.diffuse, diffuse)
        alpha = torch.where(continue_path, bounce_si.alpha, alpha)
        v = torch.where(c, -dir_world, v)

    # EPS floor on the estimate (path.cuh:254-256), then the outer mode
    # wrapping (deviceCode.cu:146-153)
    estimate = torch.clamp(color, min=EPS)
    out = torch.where(si.is_light[:, None], si.emit, estimate)
    out = torch.where(si.hit[:, None], out, ds.miss_color[None, :])
    return out, rng, alive_counts, stats
