"""LTC analytic direct lighting (deterministic, BASELINE config 1).

Counterpart of ``optix_renderer_tpu/integrators/ltc_direct.py``; reference
``ltcDirectLighingBaseline`` (cuda_src/deviceCode.cu:23-56): per-ray LTC
matrix fetch and inverse, the isotropic frame, and the analytic polygon
integral summed over every triangle light (kernel B6 on a card).
"""

from __future__ import annotations

import torch

from ..core import math as cm
from ..core.types import Ray, SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import ltc


def shading_frame(rays: Ray, si: SurfaceInteraction):
    """(to_local (N, 3, 3), wo_local (N, 3)): the hit's local frame and the
    direction back to the ray origin in it (deviceCode.cu:80)."""
    wo = cm.normalize(rays.origin - si.p, eps=1e-30)
    to_local, _ = cm.orthonormal_basis(si.n_geom)
    return to_local, cm.normalize(cm.apply_mat(to_local, wo), eps=1e-30)


def ltc_inputs(ds: DeviceScene, si: SurfaceInteraction, to_local: torch.Tensor, wo_local: torch.Tensor):
    """The per-ray LTC setup (deviceCode.cu:27-48) in the frame of
    ``shading_frame``: returns (upper (N,) bool, the arguments of
    ``ltc.integrate_over_polygon``)."""
    upper = wo_local[..., 2] >= 0.0  # :27-28 (z < 0 -> black)

    theta = cm.spherical_theta(wo_local)  # :36
    ltc_mat, amplitude = ltc.fetch_ltc_mat(si.alpha, theta)  # :38-39
    ltc_mat_inv = cm.matrix_inverse_3x3(ltc_mat)  # :40
    iso = ltc.iso_frame_from_wo_local(wo_local)  # :42-48
    return upper, (si.p, si.diffuse, to_local, iso, ltc_mat_inv, amplitude,
                   ds.light_v1, ds.light_v2, ds.light_v3, ds.light_normal, ds.light_emit)


def ltc_direct(ds: DeviceScene, si: SurfaceInteraction, to_local: torch.Tensor,
               wo_local: torch.Tensor) -> torch.Tensor:
    """LTC radiance for non-light hit lanes; garbage elsewhere (mask it)."""
    upper, args = ltc_inputs(ds, si, to_local, wo_local)
    return torch.where(upper[:, None], ltc.integrate_over_polygon(*args), 0.0)


def ltc_baseline_color(ds: DeviceScene, rays: Ray, si: SurfaceInteraction) -> torch.Tensor:
    """Full LTC_BASELINE mode color (deviceCode.cu:111-116): lights show
    their emission, misses the background, everything else the LTC sum."""
    direct = ltc_direct(ds, si, *shading_frame(rays, si))
    color = torch.where(si.is_light[:, None], si.emit, direct)
    return torch.where(si.hit[:, None], color, ds.miss_color[None, :])
