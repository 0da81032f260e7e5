"""LTC x stochastic ratio estimator (BASELINE config 3).

Counterpart of ``optix_renderer_tpu/integrators/ratio.py``: the *intended*
pipeline of ``cuda_include/ratio/ratio.cuh`` + deviceCode.cu:117-144 (the
committed kernel zeroes the BRDF, so its stochastic buffers are black).
Per pixel:

* the analytic LTC direct color (the main accumulated output), and
* ``n_samples``-sample averaged single-bounce stochastic direct lighting,
  once WITH visibility ("sto_direct") and once WITHOUT ("sto_no_vis"),
  stored as grayscale means.

The final ratio image ``ltc * D / N`` is assembled by
``postprocess.denoise.ratio_combine`` after denoising.

Deviations from the reference's quirks, kept from the JAX package:

* the solid-angle pdf of both estimators uses the *sampled* light's
  geometry (the reference reuses the shadow-hit surface's normal even when
  the ray hit a wall, ratio.cuh:51, which makes the unshadowed estimator
  depend on occluders);
* the shadowed estimator credits the *sampled* light's emission gated by
  the visibility of the sampled point (an any-hit trace to it), not the
  emission of whichever light the closest-hit shadow ray struck
  (ratio.cuh:61): with several lights of different emission the
  reference's estimator mixes pdfs and emissions of different lights.

Every lane's ``n_samples`` visibility rays go into one batched
(n_samples * N,) any-hit trace: one launch of kernel B2 per frame, or on
the cluster tier one sweep and one launch of B4.  Only the rays of lanes
that hit a non-emitting surface are traced: no buffer reads the answer of
a miss or light lane, so its rays get a t bound of exactly +0, which every
trace answers False without a test (B2 drops such lanes, K-sweep and B4
skip them).  Their light samples, RNG draws and contributions are made as
before, so every buffer keeps its bits.  ``ratio_color``'s fourth value
counts the traced lanes, one reduction a frame on the device, which
``Renderer.metrics`` reads as ``ratio_live_shadow_rays``.

A frame's RATIO work runs in four stages (``utils.launches.span``), as
PATH's ``frame.bounce.*``: ``frame.ratio.ltc`` (the LTC term, B6 on a
card), ``frame.ratio.sample`` (the shading frame and the light samples),
``frame.ratio.visibility`` (the batched trace, its ``trace.*`` stages
inside) and ``frame.ratio.combine`` (the means, the grayscale, the
buffers' ``where``s).
"""

from __future__ import annotations

import torch

from ..accel.traverse import trace_any
from ..core import math as cm
from ..core import rng as rnglib
from ..core.types import Ray, SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import ltc, material
from ..utils.launches import span
from .ltc_direct import ltc_direct
from .path_kernel import RAY_EPS, _clamp_dot, gather_light_attrs, pdf_area_to_solid_angle


def _stochastic_direct_sample(ds: DeviceScene, si: SurfaceInteraction, shadow_origin, wo_local, to_local, rng):
    """One light sample -> (unshadowed rgb, shadow ray dir, dist, rng); the
    caller batches the visibility traces of all samples."""
    num_lights = ds.num_lights
    rng, u1, u2 = rnglib.lcg_randomf2(rng)  # rand1 (ratio.cuh:29)
    rng, _, _ = rnglib.lcg_randomf2(rng)  # rand2 drawn but unused (ratio.cuh:30)
    rng, pick = rnglib.lcg_randomf(rng)  # light index (ratio.cuh:33)
    lidx = torch.clamp((pick * num_lights).to(torch.int32), 0, num_lights - 1)

    lv1, lv2, lv3, lnormal, lemit, larea = gather_light_attrs(ds, lidx)
    light_pdf_a = 1.0 / (larea * num_lights)
    lp = cm.sample_point_on_triangle(lv1, lv2, lv3, u1, u2)
    to_light = lp - shadow_origin
    dist2 = cm.dot(to_light, to_light)
    dist = cm.sqrt_rn(dist2)
    ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]

    # solid-angle pdf from the sampled light's own normal (module docstring)
    light_pdf_w = pdf_area_to_solid_angle(light_pdf_a, dist2, cm.dot(-ldir, lnormal))

    wi_local = cm.normalize(cm.apply_mat(to_local, ldir), eps=1e-30)
    brdf = material.evaluate(wi_local, wo_local, si.diffuse, si.alpha)

    weight = _clamp_dot(si.n_geom, ldir) / torch.where(light_pdf_w == 0.0, 1.0, light_pdf_w)
    contrib = lemit * brdf * weight[:, None]
    contrib = torch.where((light_pdf_w > 0.0)[:, None], cm.check_positive(contrib), 0.0)
    return contrib, ldir, dist, rng


def ratio_color(ds: DeviceScene, bvh, rays: Ray, si: SurfaceInteraction, rng_state: torch.Tensor,
                n_samples: int = 4):
    """RATIO-mode frame (deviceCode.cu:117-144).

    Returns (accumulated color = the LTC buffer (N, 3), rng, aux buffers
    {ltc (N, 3), sto_direct (N, 1), sto_no_vis (N, 1)}, live (0-d int64 on
    the device: the lanes that hit a non-emitting surface, the only ones
    whose ``n_samples`` visibility rays are traced)).
    """
    with span("frame.ratio.ltc"):
        ltc_color = ltc_direct(ds, rays, si)

    with span("frame.ratio.sample"):
        to_local, wo_local = ltc.shading_frame(rays.origin, si.p, si.n_geom)  # the stochastic samples' frame
        n = rays.origin.shape[0]
        shadow_origin = si.p + si.n_geom * RAY_EPS
        rng = rng_state
        contribs, dirs, dists = [], [], []
        for _ in range(n_samples):  # the sample average of deviceCode.cu:128-136
            c, ldir, dist, rng = _stochastic_direct_sample(ds, si, shadow_origin, wo_local, to_local, rng)
            contribs.append(c)
            dirs.append(ldir)
            dists.append(dist)

    with span("frame.ratio.visibility"):  # one batched (n_samples * N,) visibility trace
        all_rays = Ray(origin=shadow_origin.repeat(n_samples, 1), direction=torch.cat(dirs, dim=0))
        t_max = torch.cat(dists, dim=0).mul_(1.0 - 1e-3)
        # The lanes whose visibility a buffer reads: hit and not a light.  The others' rays get +0 and are not
        # traced.  The mask is made here and reduced to its count at once, so that it adds nothing to the
        # memory the light samples or the trace hold at their peak.
        live = si.hit > si.is_light
        t_max.view(n_samples, n).masked_fill_(~live[None], 0.0)
        live = live.sum()
        occ = trace_any(bvh, all_rays, t_max=t_max)
        occ = occ.reshape(n_samples, n)

    with span("frame.ratio.combine"):
        no_vis = sum(contribs) / n_samples
        direct = sum(torch.where(occ[k][:, None], 0.0, contribs[k]) for k in range(n_samples)) / n_samples

        # grayscale means (deviceCode.cu:140-143)
        g_direct = direct.mean(dim=-1, keepdim=True)
        g_no_vis = no_vis.mean(dim=-1, keepdim=True)

        # lights write raw emission into all three buffers (deviceCode.cu:118-124)
        is_l = si.is_light[:, None]
        hit = si.hit[:, None]
        ltc_buf = torch.where(is_l, si.emit, ltc_color)
        ltc_buf = torch.where(hit, ltc_buf, ds.miss_color[None, :])
        emit_gray = si.emit.mean(dim=-1, keepdim=True)
        sto_d = torch.where(hit, torch.where(is_l, emit_gray, g_direct), 0.0)
        sto_n = torch.where(hit, torch.where(is_l, emit_gray, g_no_vis), 0.0)

    aux = {"ltc": ltc_buf, "sto_direct": sto_d, "sto_no_vis": sto_n}
    return ltc_buf, rng, aux, live
