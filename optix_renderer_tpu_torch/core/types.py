"""SoA tensor types shared across the port.

Counterpart of ``optix_renderer_tpu/core/types.py``: the same fields in the
same structure-of-arrays layout, as plain dataclasses of torch tensors
(every field has a leading ray/pixel dimension).  Tensors carry their own
device; nothing here moves data.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Ray:
    """Batched rays: origin/direction (N, 3) float32."""

    origin: torch.Tensor
    direction: torch.Tensor


@dataclasses.dataclass
class Hit:
    """Raw traversal output, before attribute interpolation.

    tri_id == -1 encodes a miss; on a miss ``t`` is the ray's t_max
    (3e38 by default), as the trace kernels leave it.
    """

    t: torch.Tensor  # (N,) float32 hit distance
    tri_id: torch.Tensor  # (N,) int32 global triangle id, -1 on miss
    bary_u: torch.Tensor  # (N,) float32
    bary_v: torch.Tensor  # (N,) float32


@dataclasses.dataclass
class SurfaceInteraction:
    """Per-lane hit attributes (the reference's ``SurfaceInteraction``)."""

    hit: torch.Tensor  # (N,) bool
    p: torch.Tensor  # (N, 3) world-space hit point
    uv: torch.Tensor  # (N, 2) wrapped texture coords
    n_geom: torch.Tensor  # (N, 3) interpolated (shading) normal, 0 on miss
    diffuse: torch.Tensor  # (N, 3) base color (miss lanes: miss color)
    alpha: torch.Tensor  # (N,) roughness, clamped [0.01, 1]
    emit: torch.Tensor  # (N, 3)
    is_light: torch.Tensor  # (N,) bool
    material_id: torch.Tensor  # (N,) int32 (0 on miss)
    area: torch.Tensor  # (N,) triangle area


@dataclasses.dataclass
class Camera:
    """Pinhole camera basis; a pixel's ray direction is
    ``normalize(dir_00 + u * dir_du + v * dir_dv)`` with u, v in [0, 1)."""

    pos: torch.Tensor  # (3,)
    dir_00: torch.Tensor  # (3,)
    dir_du: torch.Tensor  # (3,)
    dir_dv: torch.Tensor  # (3,)


@dataclasses.dataclass
class GBuffers:
    """Per-frame auxiliary outputs."""

    position: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3)
    albedo: torch.Tensor  # (H, W, 3)
    alpha: torch.Tensor  # (H, W)
    uv: torch.Tensor  # (H, W, 2)
    material_id: torch.Tensor  # (H, W) float32


@dataclasses.dataclass
class RenderState:
    """Progressive-rendering state: the accumulation buffer, the number of
    completed frames and the camera.  ``accum_id`` is a host int: the host
    issues every frame, so it knows the count without asking the device."""

    accum: torch.Tensor  # (H, W, 3) running radiance sum
    accum_id: int
    camera: Camera
