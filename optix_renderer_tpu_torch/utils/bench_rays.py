"""Seeded ray batches at the shapes the main paths give the trace kernels,
shared by ``chip_smoke.py`` and ``utils/brute_bench.py``."""

from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.types import Ray
from ..engine.camera import primary_rays


def first_frame_primaries(renderer, lin: torch.Tensor) -> Ray:
    """The jittered primary rays of ``renderer``'s first frame for the pixel
    ids ``lin`` (``render_tile``: RNG stream 10007, two draws a pixel)."""
    st = rnglib.make_rng(10007, lin)
    st, ju = rnglib.lcg_randomf(st)
    st, jv = rnglib.lcg_randomf(st)
    return primary_rays(renderer.state.camera, renderer.width, renderer.height, ju, jv, lin=lin)


def bounce_like_rays(bvh, n: int, device, seed: int):
    """Rays leaving random points of the scene's triangles into the normal's
    hemisphere, offset like the path tracer's (1e-3 along the normal).
    Returns (origin, direction, t_max for a closest-hit trace, t_max for an
    occlusion trace); 30 % of each t_max are 0, as for the lanes the path
    tracer need not trace."""
    g = torch.Generator(device=device).manual_seed(seed)
    tri = torch.randint(0, bvh.num_tris, (n,), generator=g, device=device)
    su = torch.sqrt(torch.rand(n, generator=g, device=device))[:, None]
    b = torch.rand(n, generator=g, device=device)[:, None]
    p = bvh.tri_v0[tri] + su * (1.0 - b) * bvh.tri_e1[tri] + su * b * bvh.tri_e2[tri]
    nrm = bvh.tri_tab[tri, 10:13]  # the table's unit normal (sorted row = sorted triangle)
    d = torch.randn((n, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where(((d * nrm).sum(-1) < 0)[:, None], -d, d)
    o = (p + nrm * 1e-3).contiguous()
    zero = torch.rand(n, generator=g, device=device) < 0.3
    tm_closest = torch.where(zero, 0.0, 3.0e38)
    tm_any = torch.where(zero, 0.0, torch.rand(n, generator=g, device=device) * 1200.0)
    return o, d.contiguous(), tm_closest, tm_any
