"""The cluster tier's trace orchestration (counterpart of the XLA half of
``optix_renderer_tpu/accel/pallas_cluster.py``).

Scenes above ``accel.build.BRUTE_MAX_TRIS`` are traced in two steps.

1. **Sweep:** every ray's t bound is clamped by a per-ray supercluster
   sweep (``ray_t_bounds``): rays overlapping no geometry get t = 0.
   Incoherent rays take ``corridor_keys_and_t_bounds`` instead, whose
   keys sort them so that neighbouring rays cross the same superclusters.
   The sweep is one launch of the hand kernel K-sweep
   (``accel.sweep_kernel``) for rays on a CUDA device, and the plain
   PyTorch sweep below on the CPU (``_k_sweep``); both give the same bits.
2. **Walk:** kernels B3 (closest, packed key) and B4 (occlusion) of
   ``accel.cluster_trace``: each ray finds its own clusters, two levels
   deep, front to back.  Nothing is listed, so nothing is capped: no
   cull, no fallback, no host sync.  A CUDA tensor launches the kernel, a
   CPU tensor runs its plain version, which returns the same key, and the
   same cluster id wherever one cluster holds the key.

The TPU kernels needed dense per-tile lists because they cannot walk
data-dependently per lane; a CUDA warp can.  The port began with the TPU
design (a tile-frustum or per-lane cull into front-to-back lists, a list
walk, a checked fallback for cut lists), and the walk replaced it on the
1M-triangle terrain (NVIDIA H100 80GB HBM3, 700 W): a PATH depth-4 frame
went from 8,310.7 to about 308 ms, the per-lane cull alone cost about 800
ms per million incoherent rays, and on coherent primaries the walk (2.5
ms per 1024^2 rays) beat tile cull + list walk (1.7 + 0.9 ms on the
device, some 330 more launches and a host sync).

**Baked primaries.**  Rays that all share one origin (primary rays) may
come with the shared-origin table of that origin (``BakedTable``, from
``bake_shared_origin_tab``; the Renderer bakes one per camera position on
the card) and then take the baked walk.  Decode and shading read the
unbaked tables only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Hit, Ray
from ..utils.launches import span
from . import cluster_trace, sweep_kernel
from .brute_trace import moller_trumbore
from .build import CLUSTER_SIZE, SC_GROUP, BVH
from .cluster_trace import inv_dir

_INF = 3.0e38
_LOCAL_MASK = CLUSTER_SIZE - 1  # low key bits: triangle id within its cluster


def _cid_bits(n_clusters: int) -> int:
    b = 1
    while (1 << b) < n_clusters:
        b += 1
    return b


def _bcast_t(t_max, n: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(t_max, torch.Tensor):
        return t_max.to(device=like.device, dtype=torch.float32).expand(n)
    return torch.full((n,), float(t_max), dtype=torch.float32, device=like.device)


def _superclusters(cluster_min, cluster_max):
    """(S, G, padded cmin, padded cmax, sc_min, sc_max): contiguous
    groups of G cluster boxes, padded with inverted boxes."""
    C = cluster_min.shape[0]
    G = SC_GROUP
    S = -(-C // G)
    pad = S * G - C
    cmin = torch.cat([cluster_min, cluster_min.new_full((pad, 3), _INF)])
    cmax = torch.cat([cluster_max, cluster_max.new_full((pad, 3), -_INF)])
    return S, G, cmin, cmax, cmin.reshape(S, G, 3).amin(dim=1), cmax.reshape(S, G, 3).amax(dim=1)


def _sc_slab_sweep(cluster_min, cluster_max, rays: Ray):
    """Dense per-ray slab sweep over supercluster AABBs (the cluster boxes
    themselves when there are at most 512).  Returns (near, far, hit), each
    (N, S)."""
    C = cluster_min.shape[0]
    if C <= 512:
        sc_min, sc_max = cluster_min, cluster_max
    else:
        *_, sc_min, sc_max = _superclusters(cluster_min, cluster_max)
    o, d = rays.origin, rays.direction
    inv = inv_dir(d)
    near = far = None
    for a in range(3):
        t0 = (sc_min[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t1 = (sc_max[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return near, far, (near <= far) & (far > 0.0)


def _t_bound_from_sweep(far, hit, t_max, n, like):
    far_bound = torch.where(hit, far, 0.0).amax(dim=-1)
    t = _bcast_t(t_max, n, like)
    # margin: triangles exactly on a supercluster face
    return torch.where(hit.any(dim=-1), torch.minimum(t, far_bound * 1.0001 + 1e-3), 0.0)


def _sweep_cuda(cluster_min, cluster_max, rays: Ray, t_max, sc_boxes, key: bool):
    """K-sweep over the plain sweep's boxes: the cluster boxes where there
    are at most 512, else the superclusters ``sc_boxes`` (the BVH's
    ``sc_min``/``sc_max``, which equal ``_superclusters``' boxes).  Returns
    (t bound, key or None)."""
    boxes = (cluster_min, cluster_max) if cluster_min.shape[0] <= 512 else sc_boxes
    if isinstance(t_max, torch.Tensor):
        t_max = t_max.to(device=rays.origin.device, dtype=torch.float32).contiguous()
    bmin, bmax = (b.contiguous() for b in boxes)
    return sweep_kernel.sc_sweep_cuda(bmin, bmax, rays.origin.contiguous(), rays.direction.contiguous(), t_max,
                                      _cid_bits(bmin.shape[0]) if key else None)


def ray_t_bounds_plain(cluster_min, cluster_max, rays: Ray, t_max):
    """``ray_t_bounds`` in plain PyTorch on any device: what rays on the
    CPU take, and K-sweep's reference."""
    _near, far, hit = _sc_slab_sweep(cluster_min, cluster_max, rays)
    return _t_bound_from_sweep(far, hit, t_max, rays.origin.shape[0], rays.origin)


def corridor_keys_and_t_bounds_plain(cluster_min, cluster_max, rays: Ray, t_max=_INF):
    """``corridor_keys_and_t_bounds`` in plain PyTorch on any device: what
    rays on the CPU take, and K-sweep's reference."""
    near, far, hit = _sc_slab_sweep(cluster_min, cluster_max, rays)
    n = rays.origin.shape[0]
    t_eff = _t_bound_from_sweep(far, hit, t_max, n, rays.origin)

    S = near.shape[1]
    near_c = torch.where(hit, torch.clamp(near, min=0.0), _INF)
    entry_t, first = near_c.min(dim=-1)
    last_n = torch.where(hit, torch.clamp(near, min=0.0), -_INF)
    exit_t, last = last_n.max(dim=-1)
    any_hit = hit.any(dim=-1)
    mid_t = torch.where(any_hit, 0.5 * (entry_t + exit_t), 0.0)
    mid = (near_c - mid_t[:, None]).abs().argmin(dim=-1)
    first, mid, last = (a.to(torch.int32) for a in (first, mid, last))

    sb = _cid_bits(S)
    if 3 * sb <= 31:
        key = (first << (2 * sb)) | (mid << sb) | last
    elif 2 * sb <= 31:
        key = (first << sb) | last
    else:
        key = first
    return torch.where(any_hit, key, 0x7FFFFFFF), t_eff


def _k_sweep(rays: Ray) -> bool:
    """Does this sweep launch K-sweep?  Rays on a CUDA device do; the rays'
    device decides, not what the machine has."""
    return rays.origin.device.type == "cuda"


def ray_t_bounds(cluster_min, cluster_max, rays: Ray, t_max, *, sc_boxes):
    """Per-ray upper bound on any hit distance: the farthest exit of the
    superclusters the ray overlaps, 0 where it overlaps none.  Rays on a
    CUDA device take K-sweep over ``sc_boxes``, the BVH's (sc_min, sc_max);
    rays on the CPU the plain sweep, which makes them from the clusters."""
    with span("trace.sweep"):
        if _k_sweep(rays):
            return _sweep_cuda(cluster_min, cluster_max, rays, t_max, sc_boxes, key=False)[0]
        return ray_t_bounds_plain(cluster_min, cluster_max, rays, t_max)


def corridor_keys_and_t_bounds(cluster_min, cluster_max, rays: Ray, t_max=_INF, *, sc_boxes):
    """One supercluster sweep -> (coherence sort keys (N,) i32, the per-ray
    t bounds of ``ray_t_bounds``).  The key packs the ids of the first,
    middle and last overlapped supercluster along the ray, so rays sorted
    together traverse near-identical cluster sets; rays overlapping nothing
    get INT32_MAX and sort last, together.  Rays on a CUDA device take
    K-sweep, as in ``ray_t_bounds``."""
    with span("trace.sweep"):
        if _k_sweep(rays):
            t_eff, key = _sweep_cuda(cluster_min, cluster_max, rays, t_max, sc_boxes, key=True)
            return key, t_eff
        return corridor_keys_and_t_bounds_plain(cluster_min, cluster_max, rays, t_max)


# ---------------------------------------------------------------------------
# the shared-origin table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BakedTable:
    """The flat table baked for one ray origin: ``tab`` (C*64, 16) on the
    table's device, ``origin`` the (3,) float32 host copy it was baked for.
    Only the baked walk reads ``tab``; it is never decoded."""

    tab: torch.Tensor
    origin: np.ndarray


def bake_shared_origin_tab(tri_tab: torch.Tensor, origin) -> BakedTable:
    """The shared-origin rebake of the flat cluster table for rays that
    all start at ``origin`` (pallas_cluster.py::bake_shared_origin_tab, its
    component formulas and operation order).  With T = origin - v0,
    columns 0-9 of every row become n2 = e2 x e1 (det = d . n2), uvec = e2
    x T (u = (d . uvec) / det), vvec = T x e1 (v = (d . vvec) / det) and
    tconst = e2 . vvec (t = tconst / det); columns 10-15 pass through.  A
    padding row (e1 = e2 = 0) bakes to n2 = 0, a miss.  One ``torch.stack``
    writes the result: ten column writes would copy the table ten times."""
    origin = np.asarray(origin, np.float32).reshape(3).copy()
    c = lambda j: tri_tab[:, j]  # noqa: E731
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    tx = float(origin[0]) - c(0)
    ty = float(origin[1]) - c(1)
    tz = float(origin[2]) - c(2)
    n2x = e2y * e1z - e2z * e1y
    n2y = e2z * e1x - e2x * e1z
    n2z = e2x * e1y - e2y * e1x
    ux = e2y * tz - e2z * ty
    uy = e2z * tx - e2x * tz
    uz = e2x * ty - e2y * tx
    vx = ty * e1z - tz * e1y
    vy = tz * e1x - tx * e1z
    vz = tx * e1y - ty * e1x
    tc = e2x * vx + e2y * vy + e2z * vz
    tab = torch.stack([n2x, n2y, n2z, ux, uy, uz, vx, vy, vz, tc] + [c(j) for j in range(10, 16)], dim=1)
    return BakedTable(tab=tab, origin=origin)


# ---------------------------------------------------------------------------
# trace entry points
# ---------------------------------------------------------------------------

def key_t_up(key: torch.Tensor) -> torch.Tensor:
    """Conservative t decode of a packed key: OR-ing the local bits back
    gives an f32 >= the true hit t (positive floats order as their bits)."""
    return (key | _LOCAL_MASK).view(torch.float32)


def cold_start_keys(t_eff: torch.Tensor):
    """(key0, cid0) of a trace from nothing: the per-lane t bound packed as
    a key (worst local id), no cluster."""
    key0 = (t_eff.contiguous().view(torch.int32) & ~_LOCAL_MASK) | _LOCAL_MASK
    return key0, torch.full_like(key0, -1)


def trace_closest_clusters_packed(bvh: BVH, rays: Ray, t_max=_INF, *, t_eff: torch.Tensor | None = None,
                                  baked_tab: BakedTable | None = None):
    """Packed closest hit: returns (key (N,) i32, cid (N,) i32, t_eff (N,)
    f32).  ``key`` is the winning (quantized t | local triangle id) per
    lane and ``cid`` its cluster (-1 = miss); the winning SORTED triangle
    is ``cid * 64 + (key & 63)``.  ``t_eff`` (optional) is a precomputed
    ``ray_t_bounds``.  Exact: the walk caps nothing.

    ``baked_tab``: the table baked for the origin that every ray shares
    (the caller's contract; not checked, which would cost a host sync).
    The rays then take the baked walk."""
    if t_eff is None:
        t_eff = ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t_max, sc_boxes=(bvh.sc_min, bvh.sc_max))
    tab = bvh.tri_tab
    if baked_tab is not None:
        if baked_tab.tab.shape != bvh.tri_tab.shape:
            raise ValueError(f"baked table {tuple(baked_tab.tab.shape)} is not the shape of the BVH's table "
                             f"{tuple(bvh.tri_tab.shape)}")
        tab = baked_tab.tab
    key, cid = cluster_trace.trace_closest_walk(tab, bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max,
                                                rays.origin.contiguous(), rays.direction.contiguous(),
                                                *cold_start_keys(t_eff), baked=baked_tab is not None)
    return key, cid, t_eff


def decode_hits(key, cid, tri_tab, rays: Ray, t_eff) -> Hit:
    """Packed (key, cid) -> exact Hit: one row gather of the winning
    triangle's flat table row, the kernels' Moller-Trumbore repeated for
    (t, u, v), and the ORIGINAL prim id from column 9.  ``tri_tab`` is the
    unbaked table: a ``BakedTable`` holds tconst in column 9 and is refused."""
    if isinstance(tri_tab, BakedTable):
        raise ValueError("decode_hits reads the unbaked table; a baked table is for the baked walk only")
    valid = cid >= 0
    tri_sorted = torch.where(valid, cid * CLUSTER_SIZE + (key & _LOCAL_MASK), 0).long()
    rows = tri_tab[tri_sorted]
    _, t, u, v = moller_trumbore(lambda j: rows[:, j], rays.origin.unbind(1), rays.direction.unbind(1))
    return Hit(t=torch.where(valid, t, t_eff), tri_id=torch.where(valid, rows[:, 9].to(torch.int32), -1),
               bary_u=torch.where(valid, u, 0.0), bary_v=torch.where(valid, v, 0.0))


def trace_any_clusters(bvh: BVH, rays: Ray, t_max=_INF, *, t_eff: torch.Tensor | None = None) -> torch.Tensor:
    """Occlusion: occluded (N,) bool, is there a hit in (0, t bound)."""
    if t_eff is None:
        t_eff = ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t_max, sc_boxes=(bvh.sc_min, bvh.sc_max))
    return cluster_trace.trace_any_walk(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max,
                                        rays.origin.contiguous(), rays.direction.contiguous(), t_eff.contiguous())


def rays_above_scene(bvh: BVH, rays: Ray, active: torch.Tensor) -> Ray:
    """Inactive lanes rewritten to an up-ray above every cluster: the t
    bound gives them 0, and the corridor key sorts them last, together."""
    out_o = bvh.cluster_max.amax(dim=0) + 1.0
    up = torch.zeros_like(out_o)
    up.narrow(0, 1, 1).fill_(1.0)  # a device fill: no host-to-device copy
    m = active[:, None]
    return Ray(origin=torch.where(m, rays.origin, out_o[None, :]), direction=torch.where(m, rays.direction, up))


def trace_any_clusters_sorted(bvh: BVH, rays: Ray, t_max=_INF) -> torch.Tensor:
    """Corridor-sorted occlusion (the incoherent shadow-ray analog of the
    sorted closest trace): one supercluster sweep gives the sort key and
    the t bound, the rays are traced in key order and the bits unsorted.
    Lanes with ``t_max <= 0`` become above-scene up-rays."""
    n = rays.origin.shape[0]
    tmax_b = _bcast_t(t_max, n, rays.origin)
    rays_m = rays_above_scene(bvh, rays, tmax_b > 0.0)
    keys, te = corridor_keys_and_t_bounds(bvh.cluster_min, bvh.cluster_max, rays_m, tmax_b,
                                          sc_boxes=(bvh.sc_min, bvh.sc_max))
    with span("trace.sort"):
        perm = torch.argsort(keys)
    od_s = torch.cat([rays_m.origin, rays_m.direction, te[:, None]], dim=1)[perm]
    occ_s = trace_any_clusters(bvh, Ray(origin=od_s[:, 0:3], direction=od_s[:, 3:6]), t_eff=od_s[:, 6])
    occ = torch.empty_like(occ_s)
    occ[perm] = occ_s
    return occ
