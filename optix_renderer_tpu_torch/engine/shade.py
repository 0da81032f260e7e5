"""Hit shading stage: Hit -> SurfaceInteraction (counterpart of the
small-scene half of ``optix_renderer_tpu/engine/shade.py``; reference
closest-hit and miss programs, cuda_include/hit_miss.cuh:14-63).

After traversal returns (tri_id, bary), one index gather ``tri_pack[tid]``
fetches every per-triangle attribute; the JAX package does the same fetch
as a one-hot matmul at Precision.HIGHEST, which returns the same values.
"""

from __future__ import annotations

import torch

from ..accel.traverse import _INF, trace_closest, zero_trace_stats
from ..core import math as cm
from ..core.types import Hit, Ray, SurfaceInteraction
from ..scene.device import ONEHOT_MAX_TRIS, PACK_SLICES, DeviceScene
from ..scene.textures import sample_bilinear


def _finalize(ds: DeviceScene, hit: Hit, parts: dict) -> SurfaceInteraction:
    """Assemble the SurfaceInteraction from gathered per-lane attributes,
    applying the miss program semantics (hit_miss.cuh:52-63)."""
    valid = hit.tri_id >= 0
    u = hit.bary_u[:, None]
    v = hit.bary_v[:, None]
    w = 1.0 - u - v

    p = w * parts["v1"] + u * parts["v2"] + v * parts["v3"]  # utils.cuh:9-18
    n_geom = cm.normalize(w * parts["n1"] + u * parts["n2"] + v * parts["n3"], eps=1e-30)
    uv = w * parts["uv1"] + u * parts["uv2"] + v * parts["uv3"]
    uv = torch.abs(torch.fmod(uv, 1.0))  # hit_miss.cuh:34-35

    diffuse = parts["diffuse"]
    if ds.has_textures:  # shape-based: no atlas sampling without textures
        tex_id = parts["diffuse_tex"].to(torch.int32)
        tex_rgba = sample_bilinear(ds.textures, tex_id, uv[:, 0], uv[:, 1])
        diffuse = torch.where((tex_id >= 0)[:, None], tex_rgba[:, :3], diffuse)  # hit_miss.cuh:40-44

    alpha = torch.clamp(parts["alpha"], 0.01, 1.0)  # hit_miss.cuh:45-46

    vmask = valid[:, None]
    return SurfaceInteraction(
        hit=valid,
        p=torch.where(vmask, p, 0.0),
        uv=torch.where(vmask, uv, 0.0),
        n_geom=torch.where(vmask, n_geom, 0.0),
        diffuse=torch.where(vmask, diffuse, ds.miss_color[None, :]),
        alpha=torch.where(valid, alpha, 0.0),
        emit=torch.where(vmask, parts["emit"], 0.0),
        is_light=valid & parts["is_light"],
        material_id=torch.where(valid, parts["material_id"].to(torch.int32), 0),
        area=torch.where(valid, parts["area"], 0.0),
    )


def build_surface_interaction(ds: DeviceScene, rays: Ray, hit: Hit) -> SurfaceInteraction:
    """Interpolate attributes at hit points (hit_miss.cuh:14-50); fill miss
    lanes like the miss program (hit_miss.cuh:52-63) with ``ds.miss_color``."""
    if ds.num_tris > ONEHOT_MAX_TRIS:
        raise NotImplementedError(
            f"shading reads packed rows for at most {ONEHOT_MAX_TRIS} triangles; "
            "larger scenes need the cluster tier (ROADMAP.md queue A slice 3)"
        )
    rows = ds.tri_pack[torch.clamp(hit.tri_id, min=0).long()]  # (N, PACK_K)

    def take(name):
        a, b = PACK_SLICES[name]
        return rows[:, a:b] if b - a > 1 else rows[:, a]

    parts = {k: take(k) for k in ("v1", "v2", "v3", "n1", "n2", "n3", "uv1", "uv2", "uv3",
                                  "diffuse", "emit", "diffuse_tex", "alpha", "material_id", "area")}
    parts["is_light"] = take("is_light") > 0.5
    return _finalize(ds, hit, parts)


def trace_closest_si(ds: DeviceScene, bvh, rays: Ray, active: torch.Tensor | None = None):
    """Trace + shade in one step.  Returns (SurfaceInteraction, trace stats).

    ``active`` (bool (N,), optional) marks the lanes the caller will use;
    the others trace with t_max = 0, which the kernel skips, and return a
    miss.
    """
    t_max = _INF if active is None else torch.where(active, _INF, 0.0)
    hit = trace_closest(bvh, rays, t_max=t_max)
    return build_surface_interaction(ds, rays, hit), zero_trace_stats()
