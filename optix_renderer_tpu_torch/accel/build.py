"""Host build of the trace tables (numpy), uploaded as tensors.

Counterpart of ``optix_renderer_tpu/accel/build.py`` without its skip-link
node tree (the port's CPU tier is the plain versions of the kernels):
triangles are sorted by the Morton code of their centroid (stable sort),
split into v0/e1/e2, and packed into the flat (Tpad, 16) table that the
trace kernels read (``pack_tri_table``; pad rows degenerate with prim =
-1).

Scenes above ``BRUTE_MAX_TRIS`` take the cluster tier
(``accel.cluster``): the Morton order is reordered by a top-down median
split of the centroids (``median_split_order``; a Morton grid's cells do
not line up with the geometry, so its runs' boxes are loose) and cut into
fixed runs of ``CLUSTER_SIZE`` triangles whose AABBs the walk tests, the
table is padded to a multiple of 64 rows so that cluster ``c`` is rows
``[64c, 64c+64)`` (4 KB, contiguous; the JAX package's (C*8, 128) grouped
layout exists only because Mosaic cannot read at a lane offset), and the
fused shading rows ``shade_a``/``shade_b`` are stored in that order.
``cluster_area_ratio`` says how tight the boxes are.

``build_bvh_cached`` keeps the host build products in a content-addressed
``.npz`` cache (JAX build.py:262-321), so a second run of a 1M-triangle
scene loads its tables instead of sorting and packing them again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from ..utils.log import get_logger

log = get_logger()

BRUTE_MAX_TRIS = 4096  # the dispatch threshold: above it, the cluster tier
TRI_SUB = 8  # brute-tier table rows are padded to a multiple of this
CLUSTER_SIZE = 64  # triangles per cluster (cluster tier)
SC_GROUP = 64  # clusters per supercluster: contiguous runs of cluster boxes
ATTR_NRM_COLS = 12  # corner-normal group row width (9 used)
ATTR_UVM_COLS = 8  # uv/mesh/area group row width (8 used)
SHADE_A_COLS = 20  # fused decode+shade row: v0 e1 e2 | n1 n2 n3 | mesh prim
SHADE_B_COLS = 8  # corner uvs (6 used)


@dataclasses.dataclass
class BVH:
    """Trace tables (tensors on one device)."""

    tri_v0: torch.Tensor  # (T, 3) f32, build order (Morton; the median split on the cluster tier)
    tri_e1: torch.Tensor  # (T, 3) f32 (v1 - v0)
    tri_e2: torch.Tensor  # (T, 3) f32 (v2 - v0)
    prim_id: torch.Tensor  # (T,) i32 sorted slot -> original triangle id
    tri_tab: torch.Tensor  # (Tpad, 16) f32 packed table (pack_tri_table layout);
    # Tpad a multiple of 64 on the cluster tier, so cluster c is rows [64c, 64c+64)
    cluster_min: torch.Tensor  # (C, 3) f32 AABBs of the 64-triangle runs
    cluster_max: torch.Tensor  # (C, 3) f32
    shade_a: torch.Tensor  # (Tp, SHADE_A_COLS) f32 sorted order; (1, cols) on the brute tier
    shade_b: torch.Tensor  # (Tp, SHADE_B_COLS) f32
    sc_min: torch.Tensor  # (S, 3) f32 AABBs of the runs of SC_GROUP clusters (the walk kernels' first level)
    sc_max: torch.Tensor  # (S, 3) f32

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    @property
    def clustered(self) -> bool:
        """Does this scene take the cluster tier?"""
        return self.num_tris > BRUTE_MAX_TRIS


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes (uint32)."""

    def expand(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(x) << 2 | expand(y) << 1 | expand(z)).astype(np.uint32)


def split_size(n: int) -> int:
    """How many of a split node's ``n`` triangles go to its first half: the
    multiple of a supercluster's triangles (``CLUSTER_SIZE * SC_GROUP``)
    while ``n`` is above two of them, else of ``CLUSTER_SIZE``, nearest
    ``n / 2`` (a tie rounds up); ``0 < k < n`` since ``n`` is above the
    unit."""
    unit = CLUSTER_SIZE * SC_GROUP if n > 2 * CLUSTER_SIZE * SC_GROUP else CLUSTER_SIZE
    return unit * ((n + unit) // (2 * unit))


def median_split_order(centroid: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``order`` (a permutation of the triangles) reordered by a top-down
    object-median split of their centroids: a node of more than
    ``CLUSTER_SIZE`` triangles puts the ``split_size(n)`` with the smallest
    centroid coordinate on the longest axis of its centroid box (the lowest
    of equal ones) first, keeping their order within each half, and both
    halves split on.  Each half of a node starts at a multiple of its
    node's unit, so every cluster of ``CLUSTER_SIZE`` rows but the last,
    and every run of ``SC_GROUP`` clusters not cut by the last, is a node
    of the split: its box holds its own triangles only."""
    order = np.array(order, np.int32)
    cent = np.ascontiguousarray(centroid[order])
    stack = [(0, order.shape[0])]
    while stack:
        lo, hi = stack.pop()
        n = hi - lo
        if n <= CLUSTER_SIZE:
            continue
        c = cent[lo:hi]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        k = split_size(n)
        first = np.zeros(n, bool)
        first[np.argpartition(c[:, axis], k - 1)[:k]] = True
        perm = np.concatenate([np.flatnonzero(first), np.flatnonzero(~first)])
        cent[lo:hi] = c[perm]
        order[lo:hi] = order[lo:hi][perm]
        stack += [(lo + k, hi), (lo, lo + k)]
    return order


def cluster_area_ratio(bvh: BVH) -> tuple[float, float]:
    """How tight the cluster tier's tables are: the summed surface area of
    the cluster boxes over the scene box's, and the same of the
    supercluster boxes (host float64 from ``cluster_min``/``cluster_max``
    and ``sc_min``/``sc_max``)."""

    def area(lo, hi):
        d = hi - lo
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    cmin, cmax = bvh.cluster_min.cpu().double(), bvh.cluster_max.cpu().double()
    smin, smax = bvh.sc_min.cpu().double(), bvh.sc_max.cpu().double()
    scene = max(float(area(cmin.amin(dim=0, keepdim=True), cmax.amax(dim=0, keepdim=True))[0]), 1e-30)
    return float(area(cmin, cmax).sum()) / scene, float(area(smin, smax).sum()) / scene


def pack_tri_table(tri_v0, tri_e1, tri_e2, prim_id, normal=None, mesh_id=None,
                   area=None, pad_to: int = TRI_SUB) -> np.ndarray:
    """(Tpad, 16) f32 table; rows padded to ``pad_to`` with degenerate
    triangles (e1 = e2 = 0, so det = 0 and they are never hit).

    Columns: 0-2 v0 | 3-5 e1 | 6-8 e2 | 9 prim_id | 10-12 unit normal |
    13 mesh_id | 14 area | 15 pad.  Ids are exact as f32 below 2^24.
    """
    T = tri_v0.shape[0]
    Tp = -(-T // pad_to) * pad_to
    tab = np.zeros((Tp, 16), np.float32)
    tab[:T, 0:3] = np.asarray(tri_v0, np.float32)
    tab[:T, 3:6] = np.asarray(tri_e1, np.float32)
    tab[:T, 6:9] = np.asarray(tri_e2, np.float32)
    tab[:T, 9] = np.asarray(prim_id, np.float32)
    tab[T:, 9] = -1.0
    if normal is not None:
        tab[:T, 10:13] = np.asarray(normal, np.float32)
    if mesh_id is not None:
        tab[:T, 13] = np.asarray(mesh_id, np.float32)
    if area is not None:
        tab[:T, 14] = np.asarray(area, np.float32)
    return tab


def pack_attr_tab(n_corner, uv_corner, tri_mesh, area):
    """Per-triangle attribute rows in ORIGINAL triangle order, split into
    the (normals, uv+mesh+area) groups the shade rows are built from.

    n_corner (T, 3, 3) per-corner normals, uv_corner (T, 3, 2) per-corner
    uvs, tri_mesh (T,), area (T,).  Mesh ids are exact as f32 below 2^24.
    """
    T = len(tri_mesh)
    nrm = np.zeros((T, ATTR_NRM_COLS), np.float32)
    nrm[:, 0:9] = np.asarray(n_corner, np.float32).reshape(T, 9)
    uvm = np.zeros((T, ATTR_UVM_COLS), np.float32)
    uvm[:, 0:6] = np.asarray(uv_corner, np.float32).reshape(T, 6)
    uvm[:, 6] = np.asarray(tri_mesh, np.float32)
    uvm[:, 7] = np.asarray(area, np.float32)
    return nrm, uvm


def build_bvh(tri_verts: np.ndarray, device, tri_normal: np.ndarray | None = None,
              tri_mesh: np.ndarray | None = None, tri_attr=None) -> BVH:
    """Build from (T, 3, 3) float32 triangle vertices into tensors on ``device``.

    ``tri_attr`` is the ``pack_attr_tab`` pair in ORIGINAL triangle order;
    the cluster tier (above ``BRUTE_MAX_TRIS``) needs it for its shade rows.
    """
    return bvh_from_numpy(build_bvh_arrays(tri_verts, tri_normal, tri_mesh, tri_attr), device)


def build_bvh_arrays(tri_verts: np.ndarray, tri_normal: np.ndarray | None = None,
                     tri_mesh: np.ndarray | None = None, tri_attr=None) -> dict:
    """The host half of ``build_bvh``: its products as numpy arrays, the
    input of ``bvh_from_numpy``."""
    tri_verts = np.asarray(tri_verts, np.float32)
    T = tri_verts.shape[0]
    if T == 0:
        raise ValueError("empty scene")
    if T > BRUTE_MAX_TRIS and tri_attr is None:
        raise ValueError(f"a scene above {BRUTE_MAX_TRIS} triangles needs tri_attr (pack_attr_tab) for its shade rows")

    tmin = tri_verts.min(axis=1)
    tmax = tri_verts.max(axis=1)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-20)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(morton3d(q[:, 0], q[:, 1], q[:, 2]), kind="stable").astype(np.int32)
    if T > BRUTE_MAX_TRIS:
        order = median_split_order(centroid, order)

    v0 = tri_verts[order, 0]
    e1 = tri_verts[order, 1] - v0
    e2 = tri_verts[order, 2] - v0

    # cluster AABBs over fixed-size runs
    C = -(-T // CLUSTER_SIZE)
    cmin = np.full((C, 3), np.inf, np.float32)
    cmax = np.full((C, 3), -np.inf, np.float32)
    cid = np.arange(T) // CLUSTER_SIZE
    np.minimum.at(cmin, cid, tmin[order])
    np.maximum.at(cmax, cid, tmax[order])

    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    tri_tab = pack_tri_table(
        v0, e1, e2, order,
        normal=None if tri_normal is None else np.asarray(tri_normal)[order],
        mesh_id=None if tri_mesh is None else np.asarray(tri_mesh)[order],
        area=area, pad_to=CLUSTER_SIZE if T > BRUTE_MAX_TRIS else TRI_SUB,
    )
    shade_a = np.zeros((1, SHADE_A_COLS), np.float32)
    shade_b = np.zeros((1, SHADE_B_COLS), np.float32)
    if T > BRUTE_MAX_TRIS:
        nrm_o = np.asarray(tri_attr[0], np.float32)
        uvm_o = np.asarray(tri_attr[1], np.float32)
        Tp = -(-T // TRI_SUB) * TRI_SUB
        shade_a = np.zeros((Tp, SHADE_A_COLS), np.float32)
        shade_a[:T, 0:3] = v0
        shade_a[:T, 3:6] = e1
        shade_a[:T, 6:9] = e2
        shade_a[:T, 9:18] = nrm_o[order, 0:9]
        shade_a[:T, 18] = uvm_o[order, 6]  # mesh id (exact f32 < 2^24)
        shade_a[:T, 19] = order  # original prim id
        shade_a[T:, 19] = -1.0
        shade_b = np.zeros((Tp, SHADE_B_COLS), np.float32)
        shade_b[:T, 0:6] = uvm_o[order, 0:6]
    return {"tri_tab": tri_tab, "tri_v0": v0, "tri_e1": e1, "tri_e2": e2, "prim_id": order,
            "cluster_min": cmin, "cluster_max": cmax, "shade_a": shade_a, "shade_b": shade_b}


# the port's tables differ from the JAX package's (flat (C*64, 16) table,
# shade_a/shade_b rows), so its entries have a tag and a file name of their
# own: a JAX cache entry (bvh-<sha1>.npz) in the same directory is never read
_CACHE_TAG = b"optix_renderer_tpu_torch-bvh-v2"  # v2: the cluster tier's median-split order
_CACHE_PREFIX = "torch-bvh-"


def bvh_cache_key(tri_verts: np.ndarray, tri_normal=None, tri_mesh=None, tri_attr=None) -> str:
    """sha1 over everything that decides the build's products: the tag, the
    layout constants and every input array (its dtype and shape too)."""
    h = hashlib.sha1(_CACHE_TAG)
    h.update(np.int64([BRUTE_MAX_TRIS, TRI_SUB, CLUSTER_SIZE, SC_GROUP]).tobytes())
    arrays = [np.asarray(tri_verts, np.float32), tri_normal, tri_mesh]
    arrays += [None, None] if tri_attr is None else list(tri_attr)
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_bvh_cached(cache_dir: str | None, tri_verts: np.ndarray, device, **kw) -> BVH:
    """``build_bvh`` through a content-addressed cache in ``cache_dir``
    (None: just build).  The file holds the host arrays, so one entry
    serves every device; it is written to a temporary name and renamed,
    so a reader sees all of it or nothing."""
    if cache_dir is None:
        return build_bvh(tri_verts, device, **kw)
    path = os.path.join(cache_dir, f"{_CACHE_PREFIX}{bvh_cache_key(tri_verts, **kw)}.npz")
    t0 = time.perf_counter()
    if os.path.exists(path):
        with np.load(path) as z:
            arrs = {k: z[k] for k in z.files}
        log.info("bvh cache: loaded %s in %.3f s", path, time.perf_counter() - t0)
        return bvh_from_numpy(arrs, device)
    arrs = build_bvh_arrays(tri_verts, **kw)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)
    log.info("bvh cache: built and wrote %s in %.3f s", path, time.perf_counter() - t0)
    return bvh_from_numpy(arrs, device)


def supercluster_boxes(cluster_min: torch.Tensor, cluster_max: torch.Tensor):
    """(sc_min, sc_max), each (ceil(C / SC_GROUP), 3): the box of clusters
    [SC_GROUP * s, SC_GROUP * s + SC_GROUP), the last run as long as it is."""
    C = cluster_min.shape[0]
    pad = -C % SC_GROUP
    lo = torch.cat([cluster_min, cluster_min.new_full((pad, 3), float("inf"))])
    hi = torch.cat([cluster_max, cluster_max.new_full((pad, 3), float("-inf"))])
    return lo.reshape(-1, SC_GROUP, 3).amin(dim=1), hi.reshape(-1, SC_GROUP, 3).amax(dim=1)


def flat_from_grouped(grouped: np.ndarray) -> np.ndarray:
    """The JAX package's (C*8, 128) grouped cluster table as the port's flat
    (C*64, 16) table: triangle ``g*8 + s`` of cluster c sits at [8c + s,
    g*16 + j] there and at row 64c + g*8 + s here.  Column 15, where the
    grouped layout carries the cluster bounds, is zeroed."""
    C = grouped.shape[0] // 8
    flat = grouped.reshape(C, 8, 8, 16).transpose(0, 2, 1, 3).reshape(C * 64, 16).copy()
    flat[:, 15] = 0.0
    return flat


def bvh_from_numpy(arrs: dict, device) -> BVH:
    """Upload build products as numpy arrays, the port's or the JAX
    package's ``build_bvh(..., _as_arrays=True)`` (extra keys are
    ignored; a grouped cluster table is regrouped flat)."""
    tri_tab = np.asarray(arrs["tri_tab"], np.float32)
    if tri_tab.shape[1] == 128:
        tri_tab = flat_from_grouped(tri_tab)
    T = np.asarray(arrs["tri_v0"]).shape[0]
    pad = CLUSTER_SIZE if T > BRUTE_MAX_TRIS else TRI_SUB
    if tri_tab.ndim != 2 or tri_tab.shape[1] != 16 or tri_tab.shape[0] % pad:
        raise ValueError(f"tri_tab must be the flat (Tpad, 16) table with Tpad % {pad} == 0, got {tri_tab.shape}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    cluster_min, cluster_max = f32(arrs["cluster_min"]), f32(arrs["cluster_max"])
    sc_min, sc_max = supercluster_boxes(cluster_min, cluster_max)
    bvh = BVH(
        tri_v0=f32(arrs["tri_v0"]),
        tri_e1=f32(arrs["tri_e1"]),
        tri_e2=f32(arrs["tri_e2"]),
        prim_id=torch.tensor(np.asarray(arrs["prim_id"], np.int32), device=device),
        tri_tab=f32(tri_tab),
        cluster_min=cluster_min,
        cluster_max=cluster_max,
        shade_a=f32(arrs["shade_a"]),
        shade_b=f32(arrs["shade_b"]),
        sc_min=sc_min,
        sc_max=sc_max,
    )
    if bvh.clustered:
        log.info("bvh: %d clusters, box area over the scene box's: clusters %.4g, superclusters %.4g",
                 bvh.num_clusters, *cluster_area_ratio(bvh))
    return bvh
