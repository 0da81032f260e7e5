"""The plain reference of RATIO, the LTC x stochastic ratio estimator
(Heitz, Hill and McGuire, "Combining Analytic Direct Illumination and
Stochastic Shadows", I3D 2018; the reference renderer's deviceCode.cu:117-144
and ratio/ratio.cuh): chosen pixels of chosen frames, in plain PyTorch, in
any float dtype, with nothing of the renderer under test.

A frame's lane traces its jittered primary ray (``render.primary``,
``render.trace``: the same camera, RNG and trace as PATH's reference) and
keeps, at a hit on a non-emitting surface:

* ``ltc``: the analytic LTC direct light (``reference.ltc``);
* ``n_samples`` light samples, each drawn as the renderer draws it: two
  uniforms for the point on the triangle, two drawn and unused, one that
  picks a light uniformly (ratio.cuh:29-33); the sample's unshadowed value
  ``emission * BRDF * max(n . l, EPS) / pdf`` (the pdf in solid angle,
  clamped at 0), and the same gated by an occlusion trace from the
  surface, offset by 1e-3 along its normal, to 0.999 of the sampled point's
  distance;
* ``sto_direct`` (D) and ``sto_no_vis`` (N): the grayscale (channel mean)
  of the samples' mean with and without the gate.

A light shows its emission in ``ltc`` and its grayscale in D and N; a miss
is black in all three.  Each buffer is the mean over the request's frames,
summed in frame order as the renderer's sums are.  The answer at a pixel
is the offline combine ``ltc * D / N`` (``ltc_ratio_estimator.py``), with
the ratio 0 where N is not above ``RATIO_EPS`` (``postprocess.denoise.
ratio_combine``'s rule): ``combine``.

Departures from the committed reference, each the renderer's
(``integrators/ratio.py``'s docstring): the committed kernel zeroes the
BRDF, so its stochastic buffers are black, and this is the intended
estimator; the solid-angle pdf of both estimators uses the sampled light's
normal, not the shadow hit's (ratio.cuh:51); the shadowed estimator gates
the sampled light's emission by the visibility of the sampled point, not
the emission of whatever light a closest-hit shadow ray strikes
(ratio.cuh:61).  Those of the LTC term are ``reference.ltc``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ltc as ltclib
from .render import (EPS, RAY_EPS, INF, apply_mat, bsdf_eval, camera_basis, dot, draw, normalize,
                     orthonormal_basis, primary, shade, sqrt, trace)

RATIO_EPS = 1e-4  # N at or below it: no light reaches the point even unshadowed, the ratio is 0


def _to_solid_angle(pdf, dist2, cos_t):
    c = torch.abs(cos_t)
    small = c < 1e-8
    return torch.where(small, 0.0, pdf * dist2 / torch.where(small, 1.0, c))


def ratio_lanes(scene, o, d, rng, n_samples: int):
    """(ltc (R, 3), sto_direct (R,), sto_no_vis (R,)) of lanes with
    primary rays (o, d) and RNG states after the jitter draws."""
    n = o.shape[0]
    dt = scene.dtype
    _t, tid, u, v = trace(scene, o, d, torch.full((n,), INF, dtype=dt, device=o.device), True)
    si = shade(scene, tid, u, v)
    p, nrm, diffuse, alpha = si["p"], si["n"], si["diffuse"], si["alpha"]
    live = si["hit"] & ~si["is_light"]

    ltc = ltclib.ltc_direct(scene, o, p, nrm, alpha, diffuse)

    to_local, _ = orthonormal_basis(nrm)
    wo = normalize(apply_mat(to_local, normalize(o - p, eps=1e-30)), eps=1e-30)
    shadow_o = p + nrm * RAY_EPS
    L = scene.num_lights
    no_vis = torch.zeros((n, 3), dtype=dt, device=o.device)
    direct = torch.zeros_like(no_vis)
    for _ in range(n_samples):
        rng, u1 = draw(rng, dt)
        rng, u2 = draw(rng, dt)
        rng, _unused = draw(rng, dt)
        rng, _unused = draw(rng, dt)
        rng, pick = draw(rng, dt)
        li = torch.clamp((pick * L).to(torch.int32), 0, L - 1).long()
        lv = scene.light_v[li]
        su1 = sqrt(u1)[:, None]
        lp = (1.0 - su1) * lv[:, 0] + su1 * ((1.0 - u2[:, None]) * lv[:, 1] + u2[:, None] * lv[:, 2])
        to_light = lp - shadow_o
        dist2 = dot(to_light, to_light)
        dist = sqrt(dist2)
        ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]
        pdf_w = _to_solid_angle(1.0 / (scene.light_area[li] * L), dist2, dot(-ldir, scene.light_normal[li]))
        wi = normalize(apply_mat(to_local, ldir), eps=1e-30)
        weight = torch.clamp(dot(nrm, ldir), min=EPS) / torch.where(pdf_w == 0.0, 1.0, pdf_w)
        c = scene.light_emit[li] * bsdf_eval(wi, wo, diffuse, alpha) * weight[:, None]
        c = torch.where((pdf_w > 0.0)[:, None], torch.clamp(c, min=0.0), 0.0)
        occluded = trace(scene, shadow_o, ldir, torch.where(live, dist * (1.0 - 1e-3), 0.0), False)
        no_vis = no_vis + c
        direct = direct + torch.where(occluded[:, None], 0.0, c)
    g_direct = (direct / n_samples).mean(dim=-1)
    g_no_vis = (no_vis / n_samples).mean(dim=-1)
    emit_gray = si["emit"].mean(dim=-1)
    hit, is_l = si["hit"], si["is_light"]
    ltc = torch.where(hit[:, None], torch.where(is_l[:, None], si["emit"], ltc), 0.0)
    sto_d = torch.where(hit, torch.where(is_l, emit_gray, g_direct), 0.0)
    sto_n = torch.where(hit, torch.where(is_l, emit_gray, g_no_vis), 0.0)
    return ltc, sto_d, sto_n


def combine(ltc: np.ndarray, sto_direct: np.ndarray, sto_no_vis: np.ndarray) -> np.ndarray:
    """The offline combine ``ltc * D / N`` in float64: (P, 3) from ltc (P,
    3), D and N (P,)."""
    ltc, d, n = (np.asarray(a, np.float64) for a in (ltc, sto_direct, sto_no_vis))
    ratio = np.where(n > RATIO_EPS, d / np.maximum(n, RATIO_EPS), 0.0)
    return ltc * ratio[:, None]


def render_ratio_pixels(scene, cam, width: int, height: int, pixels: np.ndarray, frames: int, *,
                        n_samples: int = 4, lanes: int = 1 << 18) -> dict:
    """RATIO's buffers at ``pixels`` (linear ids ``x + y * width``, row 0 at
    the bottom) as the mean over frames 0 .. frames - 1 from the camera
    ``cam`` = (from, to, up, cos_fovy): {"ltc" (P, 3), "sto_direct" (P,),
    "sto_no_vis" (P,)}, float64 numpy.  TF32 is off, so every product is a
    float32 one where ``scene.dtype`` is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    basis = camera_basis(*cam, width, height)
    px = torch.as_tensor(np.asarray(pixels, np.int64), device=scene.device)
    p = px.numel()
    sums = None
    per = max(1, lanes // max(p, 1))  # frames a batch of lanes
    for f0 in range(0, frames, per):
        nf = min(per, frames - f0)
        fid = torch.arange(f0, f0 + nf, device=scene.device).repeat_interleave(p)
        o, d, rng = primary(scene, basis, width, height, px.repeat(nf), fid)
        out = ratio_lanes(scene, o, d, rng, n_samples)
        for k in range(nf):
            frame = [a[k * p:(k + 1) * p] for a in out]
            sums = frame if sums is None else [s + a for s, a in zip(sums, frame)]
    return {name: (s / float(max(frames, 1))).double().cpu().numpy()
            for name, s in zip(("ltc", "sto_direct", "sto_no_vis"), sums)}
