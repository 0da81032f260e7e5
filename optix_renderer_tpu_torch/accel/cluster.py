"""The cluster tier's cull and trace orchestration (counterpart of the XLA
half of ``optix_renderer_tpu/accel/pallas_cluster.py``).

Scenes above ``accel.build.BRUTE_MAX_TRIS`` are traced in one of two ways.
Every ray's t bound is first clamped by a per-ray supercluster sweep
(``ray_t_bounds``): rays overlapping no geometry get t = 0.  The sweep is
one launch of the hand kernel K-sweep (``accel.sweep_kernel``) for rays on
a CUDA device, and the plain PyTorch sweep below on the CPU; both give the
same bits.

**Walk form: rays on a CUDA device.**  The rays go straight from the sweep
to the walk kernels of ``accel.cluster_trace``: each ray finds its own
clusters on the card, two levels deep, front to back.  Nothing is listed,
so nothing is capped: no cull, no fallback, no host sync, and the trace
statistics are zero.  The TPU kernels needed dense per-tile lists because
they cannot walk data-dependently per lane; a CUDA warp can.  That holds
for incoherent rays (NEE shadow rays, bounce rays, RATIO's visibility
rays: ``refine=True``), where the eager per-lane cull cost ~800 ms per
million rays on the 1M-triangle terrain, and for coherent primaries too,
where the walk (2.5 ms per 1024^2 rays there) beats tile cull + list form
(1.7 + 0.9 ms on the device, some 330 more launches and a host sync;
NVIDIA H100 80GB HBM3, 700 W).

**List form: rays on the CPU.**

1. **Cull (PyTorch, dense):** rays are processed in tiles of
   ``cluster_trace.TILE`` = 1024 (the kernels' tile); each tile's clusters
   (64-triangle Morton runs, ``accel.build``) are slab-tested and become a
   front-to-back list of packed ``[near | cluster id]`` entries, at most
   ``DEFAULT_MAX_VISITS`` for coherent rays and ``_SC_KEEP * _SC_GROUP``
   for incoherent ones, sorted by one
   ``topk`` over the packed int32 keys (the near distance is
   floor-quantized into the high bits, so sorting the packed value sorts by
   near and carries the id).  Coherent (primary) rays use the tile-frustum
   cull ``cull_clusters``; incoherent ones ``cull_clusters_per_lane``, which
   lists a cluster only if some lane of the tile can hit it within its own
   t bound.  Above ``_TWO_LEVEL_MIN_C`` clusters both cull superclusters of
   ``_SC_GROUP`` clusters first.
2. **Intersect:** the list form of kernels B3 (closest, packed key) and B4
   (occlusion) walks each tile's list (``accel.cluster_trace``).

A tile whose list was cut (the list cap, or a supercluster cap) is
*checked*, never silently truncated: unless its achieved hit distance beats
the entry distance of the first dropped cluster, it is re-culled at single
level and full width with the per-lane achieved bound and re-traced warm
from its first-pass keys.  The result is exact for every list cap.
The JAX package's ``lax.cond`` and batched ``while_loop`` become host
control flow on the count of unresolved tiles: one host sync per trace
call, and only where ``_cull_can_drop`` says a list can be cut.

**Baked primaries.**  Rays that all share one origin (primary rays) may
come with the shared-origin table of that origin (``BakedTable``, from
``bake_shared_origin_tab``; the Renderer bakes one per camera position on
the card): CUDA rays then take the baked walk kernel, CPU rays its plain
version, never the list path.  Culls, decode and shading read the unbaked
tables only.

The device of the rays alone decides between the two (``_walks``); both
return the same hits.  ``trace_closest_lists`` and ``trace_any_lists`` are
the list form on any device (the CPU tier, and the checks that hold the
walk form against it on the card, where the list form of B3/B4 is a
kernel too).  ``refine`` picks the list form's cull and means nothing to
the walk form.

Trace statistics are ``{"overflow", "retraced", "unresolved_tiles"}``:
Python ints (0) where nothing can be cut, else a 0-dim device tensor for
``overflow`` and host ints for the other two, so that reading them back is
left to ``Renderer.metrics``.
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
from .cluster_trace import TILE, inv_dir

_INF = 3.0e38
DEFAULT_MAX_VISITS = 1024  # per-tile list cap of the coherent cull
_NEAR_BITS_TOTAL = 30  # packed list entry: [near quantized | cluster id]
_SC_GROUP = SC_GROUP  # clusters per supercluster
_SC_CAND = 64  # kept superclusters per tile, tile-frustum cull
_SC_CAND_LANE = 128  # kept superclusters per tile, per-lane cull
_SC_KEEP = 96  # per-lane list width in superclusters (96 * 64 = 6144 entries)
_TWO_LEVEL_MIN_C = 4096  # cluster count above which the culls go two-level
_FB_TILES = 128  # tiles per batch of the checked fallback
# per-lane cull: boxes per chunk so that a (tiles, 1024, chunk) temporary
# holds at most this many elements (2^26 floats = 256 MB)
_LANE_CHUNK_ELEMS = 1 << 26
_LOCAL_MASK = CLUSTER_SIZE - 1  # low key bits: triangle id within its cluster


def _cid_bits(n_clusters: int) -> int:
    b = 1
    while (1 << b) < n_clusters:
        b += 1
    return b


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def zero_trace_stats() -> dict:
    return {"overflow": 0, "retraced": 0, "unresolved_tiles": 0}


def merge_trace_stats(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _bcast_t(t_max, n: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(t_max, torch.Tensor):
        return t_max.to(device=like.device, dtype=torch.float32).expand(n)
    return torch.full((n,), float(t_max), dtype=torch.float32, device=like.device)


def _superclusters(cluster_min, cluster_max):
    """(S, G, padded cmin, padded cmax, sc_min, sc_max): Morton-contiguous
    groups of G cluster boxes, padded with inverted boxes."""
    C = cluster_min.shape[0]
    G = _SC_GROUP
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


def ray_t_bounds(cluster_min, cluster_max, rays: Ray, t_max, *, sc_boxes):
    """Per-ray upper bound on any hit distance: the farthest exit of the
    superclusters the ray overlaps, 0 where it overlaps none.  Rays on a
    CUDA device take K-sweep over ``sc_boxes``, the BVH's (sc_min, sc_max);
    rays on the CPU the plain sweep, which makes them from the clusters."""
    with span("trace.sweep"):
        if _walks(rays):
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
        if _walks(rays):
            t_eff, key = _sweep_cuda(cluster_min, cluster_max, rays, t_max, sc_boxes, key=True)
            return key, t_eff
        return corridor_keys_and_t_bounds_plain(cluster_min, cluster_max, rays, t_max)


# ---------------------------------------------------------------------------
# the culls
# ---------------------------------------------------------------------------

def _pad_edge(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad the leading axis to n_pad by repeating the last row: a zero-padded
    direction would straddle 0 on every axis and widen the tile's frustum."""
    pad = n_pad - a.shape[0]
    if pad == 0:
        return a
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])


def _tile_bounds(rays: Ray, t_max, n_pad: int):
    """Per-tile conservative ray bounds (origin box, direction interval,
    max t), each (tiles, 3) or (tiles,)."""
    tiles = n_pad // TILE
    o = _pad_edge(rays.origin, n_pad).reshape(tiles, TILE, 3)
    d = _pad_edge(rays.direction, n_pad).reshape(tiles, TILE, 3)
    tm = _pad_edge(_bcast_t(t_max, rays.origin.shape[0], rays.origin), n_pad).reshape(tiles, TILE)
    return o.amin(dim=1), o.amax(dim=1), d.amin(dim=1), d.amax(dim=1), tm.amax(dim=1)


def _tile_slab(box_comps, o_lo, o_hi, d_lo, d_hi, t_hi):
    """Conservative tile-frustum vs AABB slab test.  ``box_comps``: six
    (1, K) or (tiles, K) arrays [min.xyz, max.xyz].  Returns (near, far),
    each (tiles, K); a box overlaps the frustum iff near <= far."""
    K = box_comps[0].shape[1]
    near = torch.zeros((o_lo.shape[0], K), dtype=torch.float32, device=o_lo.device)
    far = t_hi[:, None].expand(near.shape)
    for a in range(3):
        n_lo = box_comps[a] - o_hi[:, a:a + 1]
        n_hi = box_comps[3 + a] - o_lo[:, a:a + 1]
        dl = d_lo[:, a:a + 1]
        dh = d_hi[:, a:a + 1]
        straddle = (dl <= 0.0) & (dh >= 0.0)
        rdl = 1.0 / torch.where(dl.abs() < 1e-20, 1e-20, dl)
        rdh = 1.0 / torch.where(dh.abs() < 1e-20, 1e-20, dh)
        q1, q2, q3, q4 = n_lo * rdl, n_lo * rdh, n_hi * rdl, n_hi * rdh
        near_a = torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4))
        far_a = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
        # a direction interval straddling zero: an unbounded slab interval
        near_a = torch.where(straddle, -_INF, near_a)
        far_a = torch.where(straddle, _INF, far_a)
        near = torch.maximum(near, near_a)
        far = torch.minimum(far, far_a)
    return near, far


def _pack_topk_lists(near, live, ids, id_bits: int, max_visits: int):
    """Floor-quantized near packed with the id, one topk, overflow
    accounting.  Returns (lists (tiles, max_visits) i32, counts (tiles,)
    i32, scale (tiles,) f32, overflow (tiles,) i32, near_dropped (tiles,)
    f32: the decoded entry distance of the first dropped entry, +inf if
    none)."""
    tiles, K = near.shape
    key = torch.where(live, torch.clamp(near, min=0.0), _INF)
    nb = _NEAR_BITS_TOTAL - id_bits
    D = (1 << nb) - 2
    kmax = torch.where(live, key, 0.0).amax(dim=1)
    scale = torch.clamp(kmax, min=1e-6) / D  # decode factor
    # -1: the packed near must UNDERestimate the entry distance, or the
    # front-to-back cut could skip a cluster holding a closer hit
    nearq = torch.clamp(torch.floor(key * (1.0 / scale)[:, None]) - 1.0, 0, D).to(torch.int32)
    ids = ids.expand(tiles, K)
    packed = torch.where(live, (nearq << id_bits) | ids, ((D + 1) << id_bits) | ids)

    k = min(max_visits + 1, K)
    sorted_k = torch.topk(packed, k, dim=1, largest=False, sorted=True).values
    lists = sorted_k[:, :max_visits]
    if lists.shape[1] < max_visits:
        lists = torch.cat([lists, lists[:, -1:].expand(tiles, max_visits - lists.shape[1])], dim=1)

    total = live.sum(dim=1, dtype=torch.int32)
    counts = torch.clamp(total, max=max_visits)
    overflow = total - counts
    if k > max_visits:
        dropped_q = (sorted_k[:, max_visits] >> id_bits).to(torch.float32)
        near_dropped = torch.where(overflow > 0, dropped_q * scale, _INF)
    else:
        near_dropped = torch.full((tiles,), _INF, dtype=torch.float32, device=near.device)
    return lists.contiguous(), counts, scale, overflow, near_dropped


def _sc_candidates(sc_lists, sc_counts, sb: int, K1: int, S: int, G: int, cmin, cmax, tiles: int):
    """Level 2 of a two-level cull: the cluster ids and boxes of each tile's
    kept superclusters (one row gather per supercluster)."""
    sc_ids = (sc_lists & ((1 << sb) - 1)).long()  # (tiles, K1)
    slot = torch.arange(K1, device=sc_ids.device)[None, :]
    cand_valid = slot < sc_counts[:, None]
    cand_cid_raw = (sc_ids[:, :, None] * G + torch.arange(G, device=sc_ids.device)[None, None, :]
                    ).reshape(tiles, K1 * G).to(torch.int32)
    box_comps = ([cmin[:, a].reshape(S, G)[sc_ids].reshape(tiles, K1 * G) for a in range(3)]
                 + [cmax[:, a].reshape(S, G)[sc_ids].reshape(tiles, K1 * G) for a in range(3)])
    return cand_cid_raw, torch.repeat_interleave(cand_valid, G, dim=1), box_comps


def cull_clusters(cluster_min, cluster_max, rays: Ray, t_max, n_pad: int, max_visits: int,
                  single_level: bool = False):
    """Per-tile front-to-back cluster lists from the tile frusta.

    Returns (lists (tiles, max_visits) i32 packed [nearq | cid], counts
    (tiles,) i32, scale (tiles,) f32 -- decode near as ``(entry >>
    cid_bits) * scale`` --, overflow (tiles,) i32, near_dropped (tiles,)
    f32).  Big scenes test superclusters first and keep the nearest
    ``_SC_CAND`` per tile; a tile overlapping more reports the first
    dropped supercluster's entry distance through (overflow, near_dropped).
    ``single_level=True`` has no supercluster cap, so with ``max_visits >=
    _pad128(C)`` it never overflows: the mode of the checked fallback.
    """
    tiles = n_pad // TILE
    C = cluster_min.shape[0]
    o_lo, o_hi, d_lo, d_hi, t_hi = _tile_bounds(rays, t_max, n_pad)
    cb = _cid_bits(C)
    dev = cluster_min.device
    if single_level or not (C > _TWO_LEVEL_MIN_C and C > _SC_CAND * _SC_GROUP):
        comps = [cluster_min[:, a][None, :] for a in range(3)] + [cluster_max[:, a][None, :] for a in range(3)]
        near, far = _tile_slab(comps, o_lo, o_hi, d_lo, d_hi, t_hi)
        cid = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        return _pack_topk_lists(near, near <= far, cid, cb, max_visits)

    S, G, cmin, cmax, sc_min, sc_max = _superclusters(cluster_min, cluster_max)
    sc_comps = [sc_min[:, a][None, :] for a in range(3)] + [sc_max[:, a][None, :] for a in range(3)]
    sc_near, sc_far = _tile_slab(sc_comps, o_lo, o_hi, d_lo, d_hi, t_hi)
    sb = _cid_bits(S)
    K1 = min(_SC_CAND, S)
    sc_lists, sc_counts, _, sc_overflow, sc_near_dropped = _pack_topk_lists(
        sc_near, sc_near <= sc_far, torch.arange(S, dtype=torch.int32, device=dev)[None, :], sb, K1)

    cand_cid_raw, cand_valid, box_comps = _sc_candidates(sc_lists, sc_counts, sb, K1, S, G, cmin, cmax, tiles)
    near, far = _tile_slab(box_comps, o_lo, o_hi, d_lo, d_hi, t_hi)
    # tail padding boxes are inverted but do not fail the frustum slab:
    # mask them, and clamp ids so that sentinel entries stay in bounds
    live = (near <= far) & cand_valid & (cand_cid_raw < C)
    lists, counts, scale, overflow, near_dropped = _pack_topk_lists(
        near, live, torch.clamp(cand_cid_raw, max=C - 1), cb, max_visits)
    overflow = overflow + torch.where(sc_overflow > 0, sc_overflow * G, 0)
    return lists, counts, scale, overflow, torch.minimum(near_dropped, sc_near_dropped)


def _lane_sweep(oc, ic, tl, box_comps, K: int):
    """Per-lane min-near over K boxes: for each tile and box, the entry
    distance of the nearest lane that can hit the box within its own t
    bound, +inf if none.  ``box_comps``: six (K,) shared or (tiles, K)
    per-tile arrays.  ``oc``/``ic``: origin and 1/direction, each (tiles,
    tile, 3); ``tl`` (tiles, tile, 1).  Eager PyTorch materialises every
    temporary of the slab chain, so the boxes go in chunks that keep each
    (tiles, tile, chunk) temporary at most ``_LANE_CHUNK_ELEMS``."""
    tiles, tile = tl.shape[0], tl.shape[1]
    ch = max(1, min(K, _LANE_CHUNK_ELEMS // (tiles * tile)))
    shared = box_comps[0].dim() == 1
    out = torch.empty((tiles, K), dtype=torch.float32, device=tl.device)
    for c0 in range(0, K, ch):
        c1 = min(K, c0 + ch)
        near = far = None
        for a in range(3):
            lo_b = box_comps[a][c0:c1] if shared else box_comps[a][:, None, c0:c1]
            hi_b = box_comps[3 + a][c0:c1] if shared else box_comps[3 + a][:, None, c0:c1]
            t0 = (lo_b - oc[:, :, a:a + 1]) * ic[:, :, a:a + 1]
            t1 = (hi_b - oc[:, :, a:a + 1]) * ic[:, :, a:a + 1]
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            near = lo if near is None else torch.maximum(near, lo, out=near)
            far = hi if far is None else torch.minimum(far, hi, out=far)
        lv = (near <= far) & (far > 0.0) & (near < tl)
        out[:, c0:c1] = torch.where(lv, torch.clamp(near, min=0.0), _INF).amin(dim=1)
    return out


def cull_clusters_per_lane(cluster_min, cluster_max, rays: Ray, t_max, n_pad: int, max_visits: int,
                           single_level: bool = False):
    """Per-lane cull for incoherent rays (same contract as
    ``cull_clusters``): every cluster is slab-tested against every lane
    within that lane's own t bound, so a cluster is listed only if some
    lane can hit it.  Big scenes sweep superclusters first and keep the
    nearest ``_SC_CAND_LANE`` per tile; dropped superclusters are reported
    through (overflow, near_dropped)."""
    n = rays.origin.shape[0]
    tiles = n_pad // TILE
    C = cluster_min.shape[0]
    dev = cluster_min.device
    oc = _pad_edge(rays.origin, n_pad).reshape(tiles, TILE, 3)
    ic = inv_dir(_pad_edge(rays.direction, n_pad).reshape(tiles, TILE, 3))
    tl = _pad_edge(_bcast_t(t_max, n, rays.origin), n_pad).reshape(tiles, TILE, 1)
    cb = _cid_bits(C)
    G = _SC_GROUP

    if single_level or not (C > _TWO_LEVEL_MIN_C and C > _SC_CAND_LANE * G):
        comps = [cluster_min[:, a] for a in range(3)] + [cluster_max[:, a] for a in range(3)]
        near_t = _lane_sweep(oc, ic, tl, comps, C)
        cid = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        return _pack_topk_lists(near_t, near_t < _INF, cid, cb, max_visits)

    S, G, cmin, cmax, sc_min, sc_max = _superclusters(cluster_min, cluster_max)
    sc_near = _lane_sweep(oc, ic, tl, [sc_min[:, a] for a in range(3)] + [sc_max[:, a] for a in range(3)], S)
    sb = _cid_bits(S)
    K1 = min(_SC_CAND_LANE, S)
    sc_lists, sc_counts, _, sc_overflow, sc_near_dropped = _pack_topk_lists(
        sc_near, sc_near < _INF, torch.arange(S, dtype=torch.int32, device=dev)[None, :], sb, K1)

    cand_cid_raw, cand_valid, box_comps = _sc_candidates(sc_lists, sc_counts, sb, K1, S, G, cmin, cmax, tiles)
    near_cand = _lane_sweep(oc, ic, tl, box_comps, K1 * G)
    live = (near_cand < _INF) & cand_valid & (cand_cid_raw < C)
    lists, counts, scale, overflow, near_dropped = _pack_topk_lists(
        torch.where(live, near_cand, _INF), live, torch.clamp(cand_cid_raw, max=C - 1), cb, max_visits)
    overflow = overflow + torch.where(sc_overflow > 0, sc_overflow * G, 0)
    return lists, counts, scale, overflow, torch.minimum(near_dropped, sc_near_dropped)


def _cull_can_drop(C: int, maxv: int, refine: bool) -> bool:
    """Can the first pass's cull drop live clusters?  Either the list cap
    binds (C > maxv), or the two-level sweep's supercluster cap can drop
    whole superclusters whatever the list width."""
    cand = _SC_CAND_LANE if refine else _SC_CAND
    return C > maxv or (C > _TWO_LEVEL_MIN_C and C > cand * _SC_GROUP)


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


def _first_pass_lists(bvh: BVH, rays: Ray, t_eff, n_pad: int, refine: bool):
    C = bvh.num_clusters
    if refine:  # incoherent rays: per-lane cull
        maxv = _pad128(min(_SC_KEEP * _SC_GROUP, C))
        cull = cull_clusters_per_lane
    else:
        maxv = _pad128(min(DEFAULT_MAX_VISITS, C))
        cull = cull_clusters
    with span("trace.cull"):
        return maxv, cull(bvh.cluster_min, bvh.cluster_max, rays, t_eff, n_pad, maxv)


def _tiles_of(a: torch.Tensor, n_pad: int, grid_n: int) -> torch.Tensor:
    return _pad_edge(a, n_pad).reshape(grid_n, TILE, *a.shape[1:])


def _fallback_batches(unresolved: torch.Tensor, n_un: int, grid_n: int):
    """Yield (sel (fb,) tile ids, live (fb,) bool) batches over the
    unresolved tiles, unresolved first in index order; a tail batch is
    clamped to end at grid_n, and its entries past n_un are not live."""
    fb = min(grid_n, _FB_TILES)
    with span("trace.sort"):
        order = torch.argsort(torch.where(unresolved, 0, 1).to(torch.int32), stable=True)
    ar = torch.arange(fb, device=unresolved.device)
    for i in range(-(-n_un // fb)):
        start = min(i * fb, grid_n - fb)
        yield order[start:start + fb], (start + ar) < n_un


def _walks(rays: Ray) -> bool:
    """Does this trace take the walk form (and its sweep K-sweep)?  Rays on
    a CUDA device do; the rays' device decides, not what the machine has."""
    return rays.origin.device.type == "cuda"


def cold_start_keys(t_eff: torch.Tensor):
    """(key0, cid0) of a trace from nothing: the per-lane t bound packed as
    a key (worst local id), no cluster."""
    key0 = (t_eff.contiguous().view(torch.int32) & ~_LOCAL_MASK) | _LOCAL_MASK
    return key0, torch.full_like(key0, -1)


def trace_closest_clusters_packed(bvh: BVH, rays: Ray, t_max=_INF, *, refine: bool = False,
                                  t_eff: torch.Tensor | None = None, baked_tab: BakedTable | None = None):
    """Packed closest hit: returns (key (N,) i32, cid (N,) i32, t_eff (N,)
    f32, stats).  ``key`` is the winning (quantized t | local triangle id)
    per lane and ``cid`` its cluster (-1 = miss); the winning SORTED
    triangle is ``cid * 64 + (key & 63)``.  ``t_eff`` (optional) is a
    precomputed ``ray_t_bounds``.  Exact: the walk form (``_walks``) caps
    nothing, the list form checks every list it cut.

    ``baked_tab``: the table baked for the origin that every ray shares
    (the caller's contract; not checked, which would cost a host sync).
    The rays then take the baked walk, the kernel on a CUDA device, its
    plain version on the CPU."""
    if t_eff is None:
        t_eff = ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t_max, sc_boxes=(bvh.sc_min, bvh.sc_max))
    if baked_tab is not None:
        if baked_tab.tab.shape != bvh.tri_tab.shape:
            raise ValueError(f"baked table {tuple(baked_tab.tab.shape)} is not the shape of the BVH's table "
                             f"{tuple(bvh.tri_tab.shape)}")
        walk = cluster_trace.trace_closest_walk_cuda if _walks(rays) else cluster_trace.trace_closest_walk_plain
        key, cid = walk(baked_tab.tab, bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max,
                        rays.origin.contiguous(), rays.direction.contiguous(), *cold_start_keys(t_eff), baked=True)
        return key, cid, t_eff, zero_trace_stats()
    if _walks(rays):
        key, cid = cluster_trace.trace_closest_walk_cuda(
            bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max, rays.origin.contiguous(),
            rays.direction.contiguous(), *cold_start_keys(t_eff))
        return key, cid, t_eff, zero_trace_stats()
    key, cid, stats = trace_closest_lists(bvh, rays, t_eff, refine)
    return key, cid, t_eff, stats


def trace_closest_lists(bvh: BVH, rays: Ray, t_eff: torch.Tensor, refine: bool):
    """The list form of the packed closest hit: cull (per lane if
    ``refine``), B3 over the lists, checked fallback.  Returns (key, cid,
    stats)."""
    n = rays.origin.shape[0]
    C = bvh.num_clusters
    grid_n = -(-n // TILE)
    n_pad = grid_n * TILE
    maxv, (lists, counts, scales, overflow, near_dropped) = _first_pass_lists(bvh, rays, t_eff, n_pad, refine)
    cb = _cid_bits(C)
    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    key0, cid0 = cold_start_keys(t_eff)
    key, cid = cluster_trace.trace_closest_clusters(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, lists,
                                                    counts, scales, cb, o, d, key0, cid0)
    if not _cull_can_drop(C, maxv, refine):
        return key, cid, zero_trace_stats()

    # checked fallback: a tile is exact unless its list was cut AND some
    # lane's achieved hit distance does not beat the first dropped entry
    t_tile = _tiles_of(key_t_up(key), n_pad, grid_n).amax(dim=1)
    unresolved = (overflow > 0) & (t_tile > near_dropped)
    n_un = int(unresolved.sum())  # the trace call's one host sync
    if n_un:
        maxv_full = _pad128(C)
        cull2 = cull_clusters_per_lane if refine else cull_clusters
        o_g, d_g = _tiles_of(o, n_pad, grid_n), _tiles_of(d, n_pad, grid_n)
        key_g, cid_g = _tiles_of(key, n_pad, grid_n).clone(), _tiles_of(cid, n_pad, grid_n).clone()
        # per-lane bound: the achieved key's upper decode (t_eff where no
        # hit); a lane already at or below near_dropped is exact, so it
        # rides along dead (t = 0) and keeps its key through the warm start
        t_up = torch.minimum(key_t_up(key), t_eff)
        t_up = torch.cat([t_up, t_up.new_zeros(n_pad - n)]).reshape(grid_n, TILE)
        t_up = torch.where(t_up <= near_dropped[:, None], 0.0, t_up)
        for sel, live in _fallback_batches(unresolved, n_un, grid_n):
            fb = sel.shape[0]
            rfb = Ray(origin=o_g[sel].reshape(fb * TILE, 3), direction=d_g[sel].reshape(fb * TILE, 3))
            t2 = torch.where(live[:, None], t_up[sel], 0.0).reshape(fb * TILE)
            with span("trace.fallback_cull"):
                l2, c2, s2, _, _ = cull2(bvh.cluster_min, bvh.cluster_max, rfb, t2, fb * TILE, maxv_full,
                                         single_level=True)
            k0, c0 = key_g[sel], cid_g[sel]
            kf, cf = cluster_trace.trace_closest_clusters(
                bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, l2, torch.where(live, c2, 0), s2, cb,
                rfb.origin, rfb.direction, k0.reshape(-1), c0.reshape(-1))
            key_g[sel] = torch.where(live[:, None], kf.reshape(fb, TILE), k0)
            cid_g[sel] = torch.where(live[:, None], cf.reshape(fb, TILE), c0)
        key, cid = key_g.reshape(-1)[:n], cid_g.reshape(-1)[:n]
    stats = {"overflow": overflow.sum(), "retraced": int(n_un > 0), "unresolved_tiles": n_un}
    return key, cid, stats


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


def trace_any_clusters(bvh: BVH, rays: Ray, t_max=_INF, *, refine: bool = False,
                       t_eff: torch.Tensor | None = None):
    """Occlusion: (occluded (N,) bool, stats): is there a hit in (0, t
    bound).  The walk form (``_walks``) or the list form."""
    if t_eff is None:
        t_eff = ray_t_bounds(bvh.cluster_min, bvh.cluster_max, rays, t_max, sc_boxes=(bvh.sc_min, bvh.sc_max))
    if _walks(rays):
        occ = cluster_trace.trace_any_walk_cuda(
            bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, bvh.sc_min, bvh.sc_max, rays.origin.contiguous(),
            rays.direction.contiguous(), t_eff.contiguous())
        return occ, zero_trace_stats()
    return trace_any_lists(bvh, rays, t_eff, refine)


def trace_any_lists(bvh: BVH, rays: Ray, t_eff: torch.Tensor, refine: bool):
    """The list form of the occlusion trace: cull (per lane if ``refine``),
    B4 over the lists; a tile whose list was cut and that still has
    unoccluded lanes is re-culled for those lanes at single level and full
    width, and its pass-2 hits are OR-ed in.  Returns (occluded, stats)."""
    n = rays.origin.shape[0]
    C = bvh.num_clusters
    grid_n = -(-n // TILE)
    n_pad = grid_n * TILE
    maxv, (lists, counts, scales, overflow, _) = _first_pass_lists(bvh, rays, t_eff, n_pad, refine)
    cb = _cid_bits(C)
    o, d, t_eff = rays.origin.contiguous(), rays.direction.contiguous(), t_eff.contiguous()
    occ = cluster_trace.trace_any_clusters(bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, lists, counts,
                                           scales, cb, o, d, t_eff)
    if not _cull_can_drop(C, maxv, refine):
        return occ, zero_trace_stats()

    all_occ = _tiles_of(occ, n_pad, grid_n).all(dim=1)
    unresolved = (overflow > 0) & ~all_occ
    n_un = int(unresolved.sum())  # the trace call's one host sync
    if n_un:
        maxv_full = _pad128(C)
        cull2 = cull_clusters_per_lane if refine else cull_clusters
        o_g, d_g = _tiles_of(o, n_pad, grid_n), _tiles_of(d, n_pad, grid_n)
        occ_g = _tiles_of(occ, n_pad, grid_n).clone()
        # pass 2 re-tests only the lanes still open in unresolved tiles
        lane_open = ~occ & unresolved.repeat_interleave(TILE)[:n]
        t2_g = torch.cat([torch.where(lane_open, t_eff, 0.0), t_eff.new_zeros(n_pad - n)]).reshape(grid_n, TILE)
        for sel, live in _fallback_batches(unresolved, n_un, grid_n):
            fb = sel.shape[0]
            rfb = Ray(origin=o_g[sel].reshape(fb * TILE, 3), direction=d_g[sel].reshape(fb * TILE, 3))
            t2 = torch.where(live[:, None], t2_g[sel], 0.0).reshape(fb * TILE)
            with span("trace.fallback_cull"):
                l2, c2, s2, _, _ = cull2(bvh.cluster_min, bvh.cluster_max, rfb, t2, fb * TILE, maxv_full,
                                         single_level=True)
            occ_f = cluster_trace.trace_any_clusters(
                bvh.tri_tab, bvh.cluster_min, bvh.cluster_max, l2, torch.where(live, c2, 0), s2, cb,
                rfb.origin, rfb.direction, t2)
            occ_g[sel] = occ_g[sel] | (live[:, None] & occ_f.reshape(fb, TILE))
        occ = occ_g.reshape(-1)[:n]
    stats = {"overflow": overflow.sum(), "retraced": int(n_un > 0), "unresolved_tiles": n_un}
    return occ, stats


def rays_above_scene(bvh: BVH, rays: Ray, active: torch.Tensor) -> Ray:
    """Inactive lanes rewritten to an up-ray above every cluster: the t
    bound gives them 0, and the corridor key packs them into inert tiles."""
    out_o = bvh.cluster_max.amax(dim=0) + 1.0
    up = torch.zeros_like(out_o)
    up.narrow(0, 1, 1).fill_(1.0)  # a device fill: no host-to-device copy
    m = active[:, None]
    return Ray(origin=torch.where(m, rays.origin, out_o[None, :]), direction=torch.where(m, rays.direction, up))


def trace_any_clusters_sorted(bvh: BVH, rays: Ray, t_max=_INF, refine: bool = True):
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
    occ_s, stats = trace_any_clusters(bvh, Ray(origin=od_s[:, 0:3], direction=od_s[:, 3:6]), refine=refine,
                                      t_eff=od_s[:, 6])
    occ = torch.empty_like(occ_s)
    occ[perm] = occ_s
    return occ, stats
