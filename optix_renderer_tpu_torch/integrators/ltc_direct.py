"""LTC analytic direct lighting (deterministic, BASELINE config 1).

Counterpart of ``optix_renderer_tpu/integrators/ltc_direct.py``; reference
``ltcDirectLighingBaseline`` (cuda_src/deviceCode.cu:23-56): per hit, the
shading frame, the LTC matrix fetch and inverse, the isotropic frame, and
the analytic polygon integral summed over every triangle light.  On a card
all of it is one launch of kernel B6 (``shading/ltc_kernel.py``).
"""

from __future__ import annotations

import torch

from ..core.types import Ray, SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import ltc_kernel
from ..utils.launches import span


def ltc_direct(ds: DeviceScene, rays: Ray, si: SurfaceInteraction) -> torch.Tensor:
    """LTC radiance for non-light hit lanes; garbage elsewhere (mask it).
    A CUDA tensor runs kernel B6 (or raises); a CPU tensor its plain version."""
    with span("ltc.direct"):
        args = (rays.origin.contiguous(), si.p.contiguous(), si.n_geom.contiguous(), si.alpha.contiguous(),
                si.diffuse.contiguous(),
                ltc_kernel.light_table(ds.light_v1, ds.light_v2, ds.light_v3, ds.light_normal, ds.light_emit))
        if si.p.device.type == "cuda":
            return ltc_kernel.ltc_direct_cuda(*args)
        if si.p.device.type == "cpu":
            return ltc_kernel.ltc_direct_plain(*args)
    raise ValueError(f"no LTC implementation for device {si.p.device}")


def ltc_baseline_color(ds: DeviceScene, rays: Ray, si: SurfaceInteraction) -> torch.Tensor:
    """Full LTC_BASELINE mode color (deviceCode.cu:111-116): lights show
    their emission, misses the background, everything else the LTC sum."""
    direct = ltc_direct(ds, rays, si)
    color = torch.where(si.is_light[:, None], si.emit, direct)
    return torch.where(si.hit[:, None], color, ds.miss_color[None, :])
