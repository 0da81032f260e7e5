"""G-buffer visualization modes, primary hit only (counterpart of
``optix_renderer_tpu/integrators/gbuffer.py``; reference
cuda_src/deviceCode.cu:96-109)."""

from __future__ import annotations

import torch

from ..engine.modes import RendererType

from ..core.types import SurfaceInteraction


def gbuffer_color(mode: RendererType, si: SurfaceInteraction, miss_color: torch.Tensor) -> torch.Tensor:
    """Color for one g-buffer mode; (N, 3)."""
    n = si.p.shape[0]
    if mode == RendererType.MASK:
        color = torch.ones((n, 3), dtype=torch.float32, device=si.p.device)
    elif mode == RendererType.POSITION:
        color = si.p
    elif mode == RendererType.DIFFUSE:
        color = si.diffuse
    elif mode == RendererType.ALPHA:
        color = si.alpha[:, None].expand(n, 3)
    elif mode in (RendererType.NORMALS, RendererType.SHADE_NORMALS):
        # the reference never fills the shading normal; the interpolated
        # normal equals it absent normal maps
        color = si.n_geom
    elif mode == RendererType.MATERIAL_ID:
        color = si.material_id.to(torch.float32)[:, None].expand(n, 3)
    else:
        raise ValueError(f"not a g-buffer mode: {mode}")
    # miss lanes: the configurable background (reference: black)
    return torch.where(si.hit[:, None], color, miss_color[None, :])
