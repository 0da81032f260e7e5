"""Bilinear texture sampling from the flat atlas (counterpart of
``optix_renderer_tpu/scene/textures.py``): CUDA ``tex2D<float4>`` with
LINEAR filtering and CLAMP addressing as four gathers and a lerp.  Texel
centers sit at (i + 0.5) / size.
"""

from __future__ import annotations

import torch

from .device import TextureAtlas


def sample_bilinear(atlas: TextureAtlas, tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample atlas texture ``tex_id`` at (u, v) in [0,1]^2, bilinear + clamp.

    tex_id: (N,) int32 (values < 0 sample texture 0; callers mask the
    result).  u, v: (N,).  Returns (N, 4) float32 RGBA.
    """
    tid = torch.clamp(tex_id, min=0).long()
    w = atlas.width[tid]
    h = atlas.height[tid]
    off = atlas.offset[tid]

    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]

    x0i = x0f.to(torch.int32)
    y0i = y0f.to(torch.int32)
    x0 = torch.clamp(x0i, torch.zeros_like(w), w - 1)
    x1 = torch.clamp(x0i + 1, torch.zeros_like(w), w - 1)
    y0 = torch.clamp(y0i, torch.zeros_like(h), h - 1)
    y1 = torch.clamp(y0i + 1, torch.zeros_like(h), h - 1)

    def texel(yi, xi):
        return atlas.pixels[(off + yi * w + xi).long()]

    t00 = texel(y0, x0)
    t01 = texel(y0, x1)
    t10 = texel(y1, x0)
    t11 = texel(y1, x1)
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
