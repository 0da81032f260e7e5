"""Trace dispatcher (counterpart of ``optix_renderer_tpu/accel/traverse.py``).

Two tiers, by scene size: at most ``BRUTE_MAX_TRIS`` triangles, the
brute-force kernels B1/B2 (``brute_trace``); above it, the cluster tier
(``cluster``: a supercluster sweep, then kernels B3/B4, each ray's own
two-level walk, with no cull, no lists and no host sync).  Inside a tier
the device of the rays decides, never what the machine has: a CUDA tensor
goes to the hand-written kernels, a CPU tensor to their plain PyTorch
versions, which return the same hits, any other device raises.
"""

from __future__ import annotations

import functools

import torch

from ..core.types import Hit, Ray
from ..utils.launches import span
from . import brute_trace, cluster
from .build import BRUTE_MAX_TRIS, BVH

_INF = 3.0e38


def _assert_zero_tmin(t_min) -> None:
    """The trace kernels hardcode t > 0; a nonzero t_min must fail loudly
    rather than silently differ."""
    if not (isinstance(t_min, (int, float)) and float(t_min) == 0.0):
        raise ValueError(f"the trace tiers only support t_min == 0 (got {t_min})")


def _prepare(rays: Ray, t_min, t_max):
    _assert_zero_tmin(t_min)
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


def trace_closest(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF, coherent: bool = True) -> Hit:
    """Closest hit over a ray batch; Hit in ORIGINAL triangle ids.
    ``t_max`` is a float or a per-ray (N,) tensor.  On the cluster tier it
    decodes the winners of ``trace_closest_winners``.  ``coherent`` (primary
    rays True, bounce rays False) changes no hit: the cluster tier sorts
    incoherent rays first, and on the card the brute tier's kernel B1 lets
    the warps of a coherent batch leave a test that none of their rays can
    pass."""
    o, d, tm = _prepare(rays, t_min, t_max)
    if bvh.clustered:
        r = Ray(origin=o, direction=d)
        key, cid, t_eff, _ = trace_closest_winners(bvh, r, tm, coherent=coherent)
        return cluster.decode_hits(key, cid, bvh.tri_tab, r, t_eff)
    fn = _route(o, functools.partial(brute_trace.trace_closest_cuda, coherent=coherent),
                brute_trace.trace_closest_plain)
    t, tri_id, u, v = fn(bvh.tri_tab, o, d, tm)
    return Hit(t=t, tri_id=tri_id, bary_u=u, bary_v=v)


def trace_closest_winners(bvh: BVH, rays: Ray, t_max=_INF, active: torch.Tensor | None = None,
                          coherent: bool = True, baked_tab: cluster.BakedTable | None = None):
    """The cluster tier's closest hit as packed winners: (key (N,) i32,
    cid (N,) i32, t bound (N,) f32, {}); the winning SORTED triangle is
    ``cid * 64 + (key & 63)``, cid < 0 a miss.  The empty dict is there
    for ``portbench/edge_ties.py``, which unpacks four values.

    ``active`` (bool (N,), optional) marks the lanes the caller will use;
    the others are rewritten to an up-ray above the scene, whose t bound
    is 0.  ``coherent=True`` (primary rays) traces in the given order;
    ``coherent=False`` (bounce rays) sorts the rays by their supercluster
    corridor, so that the 32 rays of a warp are neighbours, traces them
    and unsorts the outputs.  The winners are the same either way.

    ``baked_tab`` (``cluster.BakedTable``): the rays all start at its
    origin and take the baked walk.  The shared origin is refused where
    this function would break it: with ``active`` (the rewrite moves lanes
    above the scene) and with ``coherent=False`` (the sort serves
    scattered origins).
    """
    if not bvh.clustered:
        raise ValueError(f"packed winners come from the cluster tier (above {BRUTE_MAX_TRIS} triangles)")
    if baked_tab is not None and (active is not None or not coherent):
        raise ValueError("a baked table needs untouched rays that share its origin: no active mask, coherent=True")
    if active is not None:
        rays = cluster.rays_above_scene(bvh, rays, active)
    if coherent:
        return *cluster.trace_closest_clusters_packed(bvh, rays, t_max, baked_tab=baked_tab), {}
    keys, t_eff = cluster.corridor_keys_and_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t_max,
                                                     sc_boxes=(bvh.sc_min, bvh.sc_max))
    with span("trace.sort"):
        perm = torch.argsort(keys)
    od_s = torch.cat([rays.origin, rays.direction, t_eff[:, None]], dim=1)[perm]  # one gather: rays and bounds
    key_s, cid_s, _t = cluster.trace_closest_clusters_packed(bvh, Ray(origin=od_s[:, 0:3], direction=od_s[:, 3:6]),
                                                             t_eff=od_s[:, 6])
    out = torch.empty((rays.origin.shape[0], 3), dtype=torch.int32, device=key_s.device)
    out[perm] = torch.stack([key_s, cid_s, od_s[:, 6].view(torch.int32)], dim=1)  # one scatter: the three outputs
    return out[:, 0].contiguous(), out[:, 1].contiguous(), out[:, 2].contiguous().view(torch.float32), {}


def trace_any(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF, coherent: bool = True) -> torch.Tensor:
    """Visibility query: True where some hit lies in (0, t_max).  On the
    cluster tier ``coherent=False`` corridor-sorts the rays first and
    unsorts the bits after (``cluster.trace_any_clusters_sorted``), which
    changes no bit."""
    o, d, tm = _prepare(rays, t_min, t_max)
    if bvh.clustered:
        r = Ray(origin=o, direction=d)
        return cluster.trace_any_clusters(bvh, r, tm) if coherent else cluster.trace_any_clusters_sorted(bvh, r, tm)
    return _route(o, brute_trace.trace_any_cuda, brute_trace.trace_any_plain)(bvh.tri_tab, o, d, tm)


def trace_any_with_stats(bvh: BVH, rays: Ray, t_min: float = 0.0, t_max=_INF, refine: bool = False,
                         coherent: bool = True):
    """``(trace_any(...), {})``, ``refine`` ignored: the signature ``portbench/edge_ties.py`` calls."""
    return trace_any(bvh, rays, t_min, t_max, coherent=coherent), {}
