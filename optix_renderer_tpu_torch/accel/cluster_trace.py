"""Cluster-tier kernels B3 (closest hit) and B4 (occlusion), and the plain
winner-attribute gather.

Counterpart of the Pallas half of ``optix_renderer_tpu/accel/pallas_cluster.py``
(its closest-hit and any-hit kernels, ``:848`` and ``:1020``).  Each kernel
has three pieces here:

* the wrapper (``*_cuda``), which checks its inputs, allocates the outputs
  and launches the hand-written CUDA kernel in ``csrc/cluster_trace.cu`` on
  the current stream, counting each launch in ``LAUNCHES``;
* the plain PyTorch version (``*_plain``), which applies the kernel's
  per-lane rules in the same f32 order;
* the router (``trace_closest_walk``, ``trace_any_walk``): a CUDA tensor
  launches the kernel, a CPU tensor runs the plain version, any other
  device raises.

The winner-attribute kernel (``:1657``) has only its plain version here,
``fetch_winner_attrs_plain``: on the card the fetch is part of the shading
kernel K4 (``engine.shade_kernel.cluster_shade_cuda``), whose plain version
it begins.

**Walk** (B3, B4; every trace of the cluster tier).  Per ray, the kernel
slab-tests the supercluster boxes (``BVH.sc_min/sc_max``, runs of
``SC_GROUP`` = 64 clusters), then the cluster boxes of the superclusters it
passes, nearest first, and tests the 64 triangles (flat table rows [64c,
64c+64)) of every cluster whose box the ray passes within its running
bound.  The function is: per lane, the minimum packed key ``(f32 bits of t
& ~63) | local id`` (and its cluster id, taken on a strict decrease) over
the triangles of all clusters whose box the ray passes within its bound,
starting from ``key0``/``cid0`` (B3); the OR of 0 < t < t_max over them
(B4).  The plain version computes it densely with the starting bound
(every supercluster box, then the clusters of those that pass), which
prunes less and finds the same minimum; where two clusters hold the same
packed key it keeps the lower cluster id and the kernel the one it
visited first.

**Baked walk** (``baked=True`` on B3; every primary trace of the cluster
tier on the card).  Rays that all share one origin are traced against the
shared-origin table of that origin
(``accel.cluster.bake_shared_origin_tab``) with the cheaper test of
``_mt_block_baked``; the walk and the packed key are B3's.  It agrees with
the unbaked walk up to float reassociation of the same products, so a
winner tied within an ulp may differ; kernel and plain baked walk agree
bit for bit.

The kernels take an optional ``work`` tensor ((4,) int64 on the rays'
device) to which they add: the (ray, box) slab tests and the ray/triangle
tests the rules need (B4 stops inside a cluster at the first hit), and the
lane slots (32 per warp step) the warps spent on each; the ratios are the
lane utilisation.  ``walk_bound_counts`` gives the operation count of any
walk from the lanes' final bounds alone, whatever order an implementation
visits in.  While ``utils.launches.work_records`` is open, a walk launch
given no ``work`` counts into a fresh counter and appends it, with its
boxes, rays and results, to that list.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.launches import count_launch, open_work_records
from .brute_trace import moller_trumbore
from .build import CLUSTER_SIZE, SC_GROUP

MISS_KEY = 0x7FFFFFFF
N_SHADE_ATTR = 26  # the gather's rows: the 20 shade_a columns, then the 6 uv columns of shade_b
_LOCAL_MASK = CLUSTER_SIZE - 1

# Launches of each kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# versions are not counted.
LAUNCHES = {"cluster_closest_walk": 0, "cluster_closest_walk_baked": 0, "cluster_any_walk": 0}
# plain walk: lanes per dense chunk, and (lane, cluster) pairs per block of 64 Moller-Trumbore tests
_WALK_LANES = 4096
_WALK_PAIRS = 1 << 14

SOURCES = ["cluster_trace.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_library() -> ctypes.CDLL:
    """The compiled kernels (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        lib = load_library("cluster_trace", SOURCES)
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cluster_closest_walk.argtypes = [p, p, p, i32, p, p, i32, p, p, p, p, i32, p, p, p, p]
        lib.cluster_closest_walk_baked.argtypes = lib.cluster_closest_walk.argtypes
        lib.cluster_any_walk.argtypes = [p, p, p, i32, p, p, i32, p, p, p, i32, p, p, p]
        lib.cluster_group.argtypes = []
        for fn in (lib.cluster_closest_walk, lib.cluster_closest_walk_baked, lib.cluster_any_walk, lib.cluster_group):
            fn.restype = ctypes.c_int
        if lib.cluster_group() != SC_GROUP:
            raise RuntimeError(f"csrc/cluster_trace.cu walks superclusters of {lib.cluster_group()} clusters, "
                               f"the build makes them of {SC_GROUP}")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1 / direction, each component clamped to |d| >= 1e-20 (sign kept)."""
    return 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)


def _lane_slab(bmin, bmax, o, inv, t_lim):
    """Ray vs AABB within (0, t_lim), axes x, y, z in turn
    (pallas_cluster.py::_lane_slab's order).  ``bmin``/``bmax`` (..., 3)
    broadcast against ``o``/``inv`` (..., 3) and ``t_lim`` (...)."""
    near = far = None
    for a in range(3):
        t0 = (bmin[..., a] - o[..., a]) * inv[..., a]
        t1 = (bmax[..., a] - o[..., a]) * inv[..., a]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return (near <= far) & (far > 0.0) & (near < t_lim)


def _mt_block(rows, o, d):
    """Moller-Trumbore of each lane's ray against its cluster's 64 rows
    (A, 64, 16).  Returns (hit without a t bound, t), each (A, 64)."""
    hit, t, _, _ = moller_trumbore(lambda j: rows[:, :, j], (o[:, 0:1], o[:, 1:2], o[:, 2:3]),
                                   (d[:, 0:1], d[:, 1:2], d[:, 2:3]))
    return hit, t


def _mt_block_baked(rows, d):
    """The shared-origin test of each lane's ray against its cluster's 64
    baked rows (A, 64, 16), in pallas_cluster.py::_mt_chunk_baked's
    operation order (columns: n2 0-2, uvec 3-5, vvec 6-8, tconst 9).
    Returns (hit without a t bound, t), each (A, 64)."""
    c = lambda j: rows[:, :, j]  # noqa: E731
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    det = dx * c(0) + dy * c(1) + dz * c(2)
    inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
    u = (dx * c(3) + dy * c(4) + dz * c(5)) * inv
    v = (dx * c(6) + dy * c(7) + dz * c(8)) * inv
    t = c(9) * inv
    return (det.abs() >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0), t


def _walk_candidates(cmin, cmax, sc_min, sc_max, o, inv, bound):
    """Dense two-level slab tests of a chunk of lanes within ``bound`` (L,):
    returns (lane (P,), cluster (P,)) of every (lane, cluster) pair whose
    box the lane's ray passes, in lane order, and the number of cluster
    boxes in the superclusters each lane passes (L,)."""
    C = cmin.shape[0]
    sc_pass = _lane_slab(sc_min[None], sc_max[None], o[:, None], inv[:, None], bound[:, None])  # (L, S)
    li, si = sc_pass.nonzero(as_tuple=True)
    c = si[:, None] * SC_GROUP + torch.arange(SC_GROUP, device=o.device)[None, :]  # (P1, G)
    cc = c.clamp(max=C - 1)
    ok = _lane_slab(cmin[cc], cmax[cc], o[li][:, None], inv[li][:, None], bound[li][:, None]) & (c < C)
    pi, gi = ok.nonzero(as_tuple=True)
    n_box = torch.zeros(o.shape[0], dtype=torch.long, device=o.device).index_add_(0, li, (c < C).sum(dim=1))
    return li[pi], c[pi, gi], n_box


def _walk_pair_blocks(tab, cmin, cmax, sc_min, sc_max, origin, direction, bound, baked: bool = False):
    """Yield (lane (B,), cluster (B,), hit (B, 64), t (B, 64)) over every
    (lane, cluster) pair whose box the lane's ray passes within ``bound``;
    ``baked``: ``tab`` is the shared-origin table of the rays' one origin
    (the slab tests still take the rays' own origins)."""
    inv = inv_dir(direction)
    tab = tab.reshape(-1, CLUSTER_SIZE, 16)
    for l0 in range(0, origin.shape[0], _WALK_LANES):
        sl = slice(l0, l0 + _WALK_LANES)
        lane, c, _ = _walk_candidates(cmin, cmax, sc_min, sc_max, origin[sl], inv[sl], bound[sl])
        lane = lane + l0
        for p0 in range(0, lane.shape[0], _WALK_PAIRS):
            ln, cl = lane[p0:p0 + _WALK_PAIRS], c[p0:p0 + _WALK_PAIRS]
            hit, t = _mt_block_baked(tab[cl], direction[ln]) if baked else _mt_block(tab[cl], origin[ln],
                                                                                      direction[ln])
            yield ln, cl, hit, t


def trace_closest_walk_plain(tab, cmin, cmax, sc_min, sc_max, origin, direction, key0, cid0, baked: bool = False):
    """B3 in PyTorch, dense; returns (key, cid), each (N,) int32.
    ``baked``: the baked walk (``tab`` baked for the rays' shared origin)."""
    local = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=origin.device)
    # (key, cid) as one int64 so that one scatter-min keeps the lower cluster id of a tied key
    best = (key0.long() << 32) | (cid0.long() & 0xFFFFFFFF)
    bound = (key0 | _LOCAL_MASK).view(torch.float32)
    for lane, c, hit, t in _walk_pair_blocks(tab, cmin, cmax, sc_min, sc_max, origin, direction, bound, baked):
        kmin = torch.where(hit, (t.view(torch.int32) & ~_LOCAL_MASK) | local, MISS_KEY).amin(dim=1)
        better = kmin < key0[lane]  # a cluster id is taken on a strict decrease only
        best.scatter_reduce_(0, lane[better], (kmin[better].long() << 32) | c[better], "amin")
    low = best & 0xFFFFFFFF
    return (best >> 32).to(torch.int32), torch.where(low >= 2**31, low - 2**32, low).to(torch.int32)


def trace_any_walk_plain(tab, cmin, cmax, sc_min, sc_max, origin, direction, t_max):
    """B4 in PyTorch, dense; returns occluded (N,) bool."""
    occ = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for lane, _c, hit, t in _walk_pair_blocks(tab, cmin, cmax, sc_min, sc_max, origin, direction, t_max):
        occ[lane[(hit & (t < t_max[lane][:, None])).any(dim=1)]] = True
    return occ


def walk_bound_counts(cmin, cmax, sc_min, sc_max, origin, direction, t_final, occluded=None):
    """The least (slab tests, ray/triangle tests) any walk needs that ends
    with the per-lane bounds ``t_final`` (B3: the upper decode of the final
    key; B4: t_max): every supercluster box, the cluster boxes (64, fewer in
    the last) of each supercluster that passes within the bound, and the 64
    triangles of each cluster that passes within it.  An ``occluded`` lane
    (B4) counts the supercluster boxes, one supercluster's 64 cluster boxes
    and one cluster; a lane whose bound is not above 0 counts nothing."""
    inv = inv_dir(direction)
    S = sc_min.shape[0]
    slabs = tests = 0
    for l0 in range(0, origin.shape[0], _WALK_LANES):
        sl = slice(l0, l0 + _WALK_LANES)
        lane, _c, n_box = _walk_candidates(cmin, cmax, sc_min, sc_max, origin[sl], inv[sl], t_final[sl])
        n_cl = torch.bincount(lane, minlength=n_box.shape[0])
        if occluded is not None:
            n_box = torch.where(occluded[sl], SC_GROUP, n_box)
            n_cl = torch.where(occluded[sl], 1, n_cl)
        live = t_final[sl] > 0.0
        slabs += int((live * (S + n_box)).sum())
        tests += CLUSTER_SIZE * int((live * n_cl).sum())
    return slabs, tests


def winner_rows(key, cid):
    """Sorted triangle id of each lane's winner (0 on a miss) and the hit mask."""
    valid = cid >= 0
    return torch.where(valid, cid * CLUSTER_SIZE + (key & _LOCAL_MASK), 0).long(), valid


def fetch_winner_attrs_plain(shade_a, shade_b, key, cid):
    """The winner-attribute kernel's function as an index gather
    (pallas_cluster's fallback ``_gather_cols``, with zeros on a miss):
    (26, N) f32."""
    rows, valid = winner_rows(key, cid)
    cols = torch.cat([shade_a[rows], shade_b[rows, :6]], dim=1)
    return torch.where(valid[:, None], cols, 0.0).t().contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check(dev, **tensors) -> None:
    for name, (a, dtype) in tensors.items():
        _require(a.device.type == "cuda" and a.device == dev, f"{name} must be on the rays' CUDA device, got {a.device}")
        _require(a.dtype == dtype, f"{name} must be {dtype}, got {a.dtype}")
        _require(a.is_contiguous(), f"{name} must be contiguous (got strides {a.stride()})")


def _check_walk(tab, cmin, cmax, sc_min, sc_max, origin, direction, work) -> int:
    """What B3 and B4 take: the flat table, the cluster and supercluster
    boxes, the rays and the optional counters.  Returns the number of rays."""
    n = origin.shape[0] if origin.dim() == 2 else -1
    C = cmin.shape[0]
    S = -(-C // SC_GROUP)
    _require(origin.dim() == 2 and origin.shape[1] == 3, f"origin must be (N, 3), got {tuple(origin.shape)}")
    _require(tuple(direction.shape) == (n, 3), f"direction must be ({n}, 3), got {tuple(direction.shape)}")
    _require(tab.dim() == 2 and tuple(tab.shape) == (C * CLUSTER_SIZE, 16),
             f"tab must be the flat (C*64, 16) table for C = {C} clusters, got {tuple(tab.shape)}")
    _require(tuple(cmax.shape) == (C, 3) and tuple(cmin.shape) == (C, 3), "cluster boxes must be (C, 3)")
    _require(tuple(sc_min.shape) == (S, 3) and tuple(sc_max.shape) == (S, 3),
             f"supercluster boxes must be ({S}, 3): one per run of {SC_GROUP} clusters")
    _require(n < 2**31 and tab.numel() < 2**31, "more than 2^31 - 1 rays or table elements")
    _require(tab.data_ptr() % 16 == 0, "tab must be 16-byte aligned (the kernels copy its rows 16 bytes at a time)")
    _check(origin.device, tab=(tab, torch.float32), cmin=(cmin, torch.float32), cmax=(cmax, torch.float32),
           sc_min=(sc_min, torch.float32), sc_max=(sc_max, torch.float32), origin=(origin, torch.float32),
           direction=(direction, torch.float32))
    if work is not None:
        _require(tuple(work.shape) == (4,), "work must be (4,)")
        _check(origin.device, work=(work, torch.int64))
    return n


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(a) -> int | None:
    return None if a is None else a.data_ptr()


def _launch_work(work, device):
    """(counter, records): ``work`` and None, or where the caller gave no
    counter and ``utils.launches.work_records`` is open on this thread, a
    zeroed counter and the list its launch goes into (``_record_work``)."""
    records = open_work_records()
    if work is not None or records is None:
        return work, None
    return torch.zeros(4, dtype=torch.int64, device=device), records


def _record_work(records, name: str, work, boxes, *rays) -> None:
    """One walk launch into ``records``: its counter, its (cmin, cmax,
    sc_min, sc_max) and copies of its rays and results, which the frame
    may overwrite after it."""
    if records is not None:
        records.append((name, work, boxes, tuple(a.clone() for a in rays)))


def trace_closest_walk_cuda(tab, cmin, cmax, sc_min, sc_max, origin, direction, key0, cid0, work=None,
                            baked: bool = False):
    """Kernel B3 on the card: (key, cid) as trace_closest_walk_plain with the
    same ``baked``, which launches the baked walk kernel."""
    name = "cluster_closest_walk_baked" if baked else "cluster_closest_walk"
    n = _check_walk(tab, cmin, cmax, sc_min, sc_max, origin, direction, work)
    _require(tuple(key0.shape) == (n,) and tuple(cid0.shape) == (n,), f"key0 and cid0 must be ({n},)")
    _check(origin.device, key0=(key0, torch.int32), cid0=(cid0, torch.int32))
    key = torch.empty(n, dtype=torch.int32, device=origin.device)
    cid = torch.empty_like(key)
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return key, cid
    work, records = _launch_work(work, origin.device)
    with torch.cuda.device(origin.device):
        err = getattr(kernel_library(), name)(
            tab.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), cmin.shape[0], sc_min.data_ptr(), sc_max.data_ptr(),
            sc_min.shape[0], origin.data_ptr(), direction.data_ptr(), key0.data_ptr(), cid0.data_ptr(), n,
            key.data_ptr(), cid.data_ptr(), _ptr(work), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    count_launch(LAUNCHES, name, "closest_walk_kernel")
    _record_work(records, name, work, (cmin, cmax, sc_min, sc_max), origin, direction, key0, key)
    return key, cid


def trace_any_walk_cuda(tab, cmin, cmax, sc_min, sc_max, origin, direction, t_max, work=None):
    """Kernel B4 on the card: occluded as trace_any_walk_plain."""
    n = _check_walk(tab, cmin, cmax, sc_min, sc_max, origin, direction, work)
    _require(tuple(t_max.shape) == (n,), f"t_max must be ({n},), got {tuple(t_max.shape)}")
    _check(origin.device, t_max=(t_max, torch.float32))
    occ = torch.empty(n, dtype=torch.bool, device=origin.device)  # one byte per ray
    if n == 0:
        return occ
    work, records = _launch_work(work, origin.device)
    lib = kernel_library()
    with torch.cuda.device(origin.device):
        err = lib.cluster_any_walk(
            tab.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), cmin.shape[0], sc_min.data_ptr(), sc_max.data_ptr(),
            sc_min.shape[0], origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), n, occ.data_ptr(),
            _ptr(work), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "cluster_any_walk")
    count_launch(LAUNCHES, "cluster_any_walk", "any_walk_kernel")
    _record_work(records, "cluster_any_walk", work, (cmin, cmax, sc_min, sc_max), origin, direction, t_max, occ)
    return occ


# ---------------------------------------------------------------------------
# routing by the rays' device
# ---------------------------------------------------------------------------

def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no cluster-trace implementation for device {t.device}")


def trace_closest_walk(tab, cmin, cmax, sc_min, sc_max, origin, direction, key0, cid0, baked: bool = False):
    """B3: (key, cid), each (N,) int32; ``baked``: the baked walk."""
    fn = _route(origin, trace_closest_walk_cuda, trace_closest_walk_plain)
    return fn(tab, cmin, cmax, sc_min, sc_max, origin, direction, key0, cid0, baked=baked)


def trace_any_walk(tab, cmin, cmax, sc_min, sc_max, origin, direction, t_max):
    """B4: occluded (N,) bool."""
    return _route(origin, trace_any_walk_cuda, trace_any_walk_plain)(tab, cmin, cmax, sc_min, sc_max, origin,
                                                                     direction, t_max)

