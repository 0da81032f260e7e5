"""Hit shading stage: Hit -> SurfaceInteraction (counterpart of
``optix_renderer_tpu/engine/shade.py``; reference closest-hit and miss
programs, cuda_include/hit_miss.cuh:14-63).

Small scenes (brute tier): after traversal returns (tri_id, bary), one
index gather ``tri_pack[tid]`` fetches every per-triangle attribute; the
JAX package does the same fetch as a one-hot matmul at Precision.HIGHEST,
which returns the same values.  On the card the whole of it, gather,
interpolation, texture sample and miss fill, is one launch of kernel K3
(``shade_kernel``); ``build_surface_interaction`` is its plain version.

Big scenes (cluster tier): the trace returns the packed winner (key, cid)
per lane; ``accel.cluster_trace.fetch_winner_attrs_plain`` gathers the
winning triangle's 26 shade columns, and ``build_surface_interaction_fused``
recomputes exact (t, u, v) from them and interpolates the corner normals
and uvs; the per-mesh material row is an index gather.  On the card the
whole of it is one launch of kernel K4 (``shade_kernel``);
``shade_winners_plain`` is its plain version.
"""

from __future__ import annotations

import torch

from ..accel import cluster_trace
from ..accel.brute_trace import moller_trumbore
from ..accel.build import BRUTE_MAX_TRIS
from ..accel.traverse import _INF, trace_closest, trace_closest_winners
from ..core import math as cm
from ..core.types import Hit, Ray, SurfaceInteraction
from ..scene.device import ONEHOT_MAX_TRIS, PACK_SLICES, DeviceScene
from ..scene.textures import sample_bilinear
from ..utils.launches import span
from . import shade_kernel


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
        raise ValueError(
            f"shading reads packed rows for at most {ONEHOT_MAX_TRIS} triangles; "
            "larger scenes shade the cluster tier's winners (trace_closest_si)"
        )
    rows = ds.tri_pack[torch.clamp(hit.tri_id, min=0).long()]  # (N, PACK_K)

    def take(name):
        a, b = PACK_SLICES[name]
        return rows[:, a:b] if b - a > 1 else rows[:, a]

    parts = {k: take(k) for k in ("v1", "v2", "v3", "n1", "n2", "n3", "uv1", "uv2", "uv3",
                                  "diffuse", "emit", "diffuse_tex", "alpha", "material_id", "area")}
    parts["is_light"] = take("is_light") > 0.5
    return _finalize(ds, hit, parts)


def _mesh_attr_rows(ds: DeviceScene, mesh_id: torch.Tensor) -> torch.Tensor:
    """(N, 10) per-lane mesh attributes [diffuse3, emit3, alpha, is_light,
    material_id, diffuse_tex] (the SBT record fetch of hit_miss.cuh) as an
    index gather; the JAX package's one-hot matmul returns the same values."""
    pack = torch.cat([
        ds.mesh_diffuse, ds.mesh_emit, ds.mesh_alpha[:, None], ds.mesh_is_light.to(torch.float32)[:, None],
        ds.mesh_material_id.to(torch.float32)[:, None], ds.mesh_diffuse_tex.to(torch.float32)[:, None],
    ], dim=1)
    return pack[mesh_id.long()]


def build_surface_interaction_fused(ds: DeviceScene, rays: Ray, cid: torch.Tensor,
                                    cols: torch.Tensor) -> SurfaceInteraction:
    """SurfaceInteraction from the cluster tier's winners: ``cols`` (26, N)
    are the winning triangles' shade columns (``cluster_trace.
    fetch_winner_attrs_plain``: v0 e1 e2 | n1 n2 n3 | mesh prim | uv1 uv2 uv3),
    ``cid`` < 0 marks a miss.  The kernels' Moller-Trumbore is repeated for
    exact (t, u, v); the area is 0.5 |e1 x e2|.  Matches hit_miss.cuh:14-50
    in the operation order of the JAX package's fused build."""
    valid = cid >= 0
    c = lambda j: cols[j]  # noqa: E731
    _, t, u, v = moller_trumbore(c, rays.origin.unbind(1), rays.direction.unbind(1))
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)

    w = 1.0 - u - v
    n_geom = cm.normalize(torch.stack([w * c(9) + u * c(12) + v * c(15),
                                       w * c(10) + u * c(13) + v * c(16),
                                       w * c(11) + u * c(14) + v * c(17)], dim=-1), eps=1e-30)
    ax = e1y * e2z - e1z * e2y
    ay = e1z * e2x - e1x * e2z
    az = e1x * e2y - e1y * e2x
    area = 0.5 * cm.sqrt_rn(ax * ax + ay * ay + az * az)
    p = rays.origin + t[:, None] * rays.direction

    rows = _mesh_attr_rows(ds, torch.where(valid, c(18).to(torch.int32), 0))
    diffuse = rows[:, 0:3]
    uv = torch.stack([w * c(20) + u * c(22) + v * c(24), w * c(21) + u * c(23) + v * c(25)], dim=-1)
    uv = torch.abs(torch.fmod(uv, 1.0))  # hit_miss.cuh:34-35
    if ds.has_textures:
        tex_id = rows[:, 9].to(torch.int32)
        tex_rgba = sample_bilinear(ds.textures, tex_id, uv[:, 0], uv[:, 1])
        diffuse = torch.where((tex_id >= 0)[:, None], tex_rgba[:, :3], diffuse)

    vmask = valid[:, None]
    return SurfaceInteraction(
        hit=valid,
        p=torch.where(vmask, p, 0.0),
        uv=torch.where(vmask, uv, 0.0),
        n_geom=torch.where(vmask, n_geom, 0.0),
        diffuse=torch.where(vmask, diffuse, ds.miss_color[None, :]),
        alpha=torch.where(valid, torch.clamp(rows[:, 6], 0.01, 1.0), 0.0),
        emit=torch.where(vmask, rows[:, 3:6], 0.0),
        is_light=valid & (rows[:, 7] > 0.5),
        material_id=torch.where(valid, rows[:, 8].to(torch.int32), 0),
        area=torch.where(valid, area, 0.0),
    )


def shade_winners_plain(ds: DeviceScene, shade_a: torch.Tensor, shade_b: torch.Tensor, rays: Ray,
                        key: torch.Tensor, cid: torch.Tensor) -> SurfaceInteraction:
    """The cluster tier's winners (``key``, ``cid``; cid < 0 a miss) to the
    SurfaceInteraction of ``rays``: the shade columns' gather, then the
    fused build.  K4's plain version."""
    return build_surface_interaction_fused(ds, rays, cid,
                                           cluster_trace.fetch_winner_attrs_plain(shade_a, shade_b, key, cid))


def _cluster_shade(dev: torch.device, plain: bool):
    """The cluster tier's winners -> SurfaceInteraction for lanes on
    ``dev``: kernel K4 on a CUDA device (its plain version only when the
    caller asks, ``plain=True``), the plain version on the CPU; any other
    device raises."""
    if dev.type == "cuda" and not plain:  # the kernel reads (N, 3) rows; the plain pair takes any layout
        return lambda ds, a, b, rays, key, cid: shade_kernel.cluster_shade_cuda(
            ds, a, b, Ray(origin=rays.origin.contiguous(), direction=rays.direction.contiguous()), key, cid)
    if dev.type in ("cuda", "cpu"):
        return shade_winners_plain
    raise ValueError(f"no shading for device {dev}")


def _brute_shade(dev: torch.device, plain: bool):
    """The brute tier's Hit -> SurfaceInteraction for lanes on ``dev``:
    kernel K3 on a CUDA device (its plain version only when the caller
    asks, ``plain=True``), the plain version on the CPU; any other device
    raises."""
    if dev.type == "cuda" and not plain:
        return lambda ds, rays, hit: shade_kernel.brute_shade_cuda(ds, hit)
    if dev.type in ("cuda", "cpu"):
        return build_surface_interaction
    raise ValueError(f"no shading for device {dev}")


def trace_closest_si(ds: DeviceScene, bvh, rays: Ray, active: torch.Tensor | None = None,
                     coherent: bool = True, baked_tab=None, t_max: torch.Tensor | None = None,
                     plain: bool = False):
    """Trace + shade in one step: the SurfaceInteraction of each ray.

    ``active`` (bool (N,), optional) marks the lanes the caller will use;
    the others return a miss.  On the brute tier they trace with t_max = 0,
    which the kernel skips (``t_max``: that per-lane bound,
    ``where(active, INF, 0)``, when the caller already has it); on the
    cluster tier ``accel.traverse.trace_closest_winners`` rewrites them to
    an up-ray above the scene.  ``coherent`` picks that function's ray order
    and, on the brute tier, whether kernel B1's warps vote to leave a test
    (primary rays True, bounce rays False); the closest hit is the same
    either way.  The tier decides the shading: the brute tier's
    Hit reads the packed rows (kernel K3 on a CUDA tensor), the cluster
    tier's winners their rows of the shade tables (kernel K4 on a CUDA
    tensor); ``plain=True`` takes their plain versions there too.

    ``baked_tab`` (cluster tier, ``accel.cluster.BakedTable``): the rays
    share its origin and take the baked walk; the shading still reads the
    unbaked rows.
    """
    if baked_tab is not None and not bvh.clustered:
        raise ValueError(f"baked tables belong to the cluster tier (above {BRUTE_MAX_TRIS} triangles)")
    if not bvh.clustered:
        if t_max is None:
            t_max = _INF if active is None else torch.where(active, _INF, 0.0)
        hit = trace_closest(bvh, rays, t_max=t_max, coherent=coherent)
        with span("trace.shade"):
            return _brute_shade(hit.tri_id.device, plain)(ds, rays, hit)
    key, cid, _t_eff, _ = trace_closest_winners(bvh, rays, active=active, coherent=coherent, baked_tab=baked_tab)
    with span("trace.shade"):
        return _cluster_shade(key.device, plain)(ds, bvh.shade_a, bvh.shade_b, rays, key, cid)
