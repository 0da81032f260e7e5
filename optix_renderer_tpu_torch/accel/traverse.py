"""Trace dispatcher (counterpart of ``optix_renderer_tpu/accel/traverse.py``).

Dispatch is on the device of the rays, never on what the machine has: a
CUDA tensor goes to the hand-written kernels B1/B2 (``brute_trace``), a CPU
tensor to their plain PyTorch versions.  Only the brute-force tier exists
(at most 4096 triangles); it has no cull, so its trace statistics are the
zero dict.
"""

from __future__ import annotations

import torch

from ..core.types import Hit, Ray
from . import brute_trace
from .build import BVH, check_brute_size

_INF = 3.0e38


def zero_trace_stats() -> dict:
    """The cluster tier's trace statistics; always zero on the brute tier."""
    return {"overflow": 0, "retraced": 0, "unresolved_tiles": 0}


def _assert_zero_tmin(t_min) -> None:
    """The trace kernels hardcode t > 0; a nonzero t_min must fail loudly
    rather than silently differ."""
    if not (isinstance(t_min, (int, float)) and float(t_min) == 0.0):
        raise ValueError(f"the trace tiers only support t_min == 0 (got {t_min})")


def _prepare(bvh: BVH, rays: Ray, t_min, t_max):
    _assert_zero_tmin(t_min)
    check_brute_size(bvh.num_tris)
    o = rays.origin.contiguous()
    d = rays.direction.contiguous()
    n = o.shape[0]
    if isinstance(t_max, torch.Tensor):
        tm = t_max.to(device=o.device, dtype=torch.float32).expand(n).contiguous()
    else:  # a fill on the device: no host-to-device copy
        tm = torch.full((n,), float(t_max), dtype=torch.float32, device=o.device)
    return o, d, tm


def _route(o: torch.Tensor, cuda_fn, plain_fn):
    if o.device.type == "cuda":
        return cuda_fn
    if o.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no trace implementation for device {o.device}")


def trace_closest(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> Hit:
    """Closest hit over a ray batch; Hit in ORIGINAL triangle ids.
    ``t_max`` is a float or a per-ray (N,) tensor."""
    o, d, tm = _prepare(bvh, rays, t_min, t_max)
    fn = _route(o, brute_trace.trace_closest_cuda, brute_trace.trace_closest_plain)
    t, tri_id, u, v = fn(bvh.tri_tab, o, d, tm)
    return Hit(t=t, tri_id=tri_id, bary_u=u, bary_v=v)


def trace_any(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF) -> torch.Tensor:
    """Visibility query: True where some hit lies in (0, t_max)."""
    occ, _stats = trace_any_with_stats(bvh, rays, t_min, t_max)
    return occ


def trace_any_with_stats(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF):
    """Visibility query returning (occluded (N,) bool, trace stats dict)."""
    o, d, tm = _prepare(bvh, rays, t_min, t_max)
    fn = _route(o, brute_trace.trace_any_cuda, brute_trace.trace_any_plain)
    return fn(bvh.tri_tab, o, d, tm), zero_trace_stats()
