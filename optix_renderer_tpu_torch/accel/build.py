"""Host build of the brute-force tier's triangle table (numpy), uploaded as
tensors.

Counterpart of the small-scene half of ``optix_renderer_tpu/accel/build.py``:
triangles are sorted by the Morton code of their centroid (stable sort),
split into v0/e1/e2, and packed into the (Tpad, 16) table that the trace
kernels read (``pack_tri_table``; Tpad a multiple of 8, pad rows degenerate
with prim = -1).  The skip-link node tree and the clusters belong to the
big-scene tier, which this package does not have yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BRUTE_MAX_TRIS = 4096
TRI_SUB = 8  # table rows are padded to a multiple of this


@dataclasses.dataclass
class BVH:
    """Brute-tier acceleration data (tensors on one device)."""

    tri_v0: torch.Tensor  # (T, 3) f32, Morton-sorted order
    tri_e1: torch.Tensor  # (T, 3) f32 (v1 - v0)
    tri_e2: torch.Tensor  # (T, 3) f32 (v2 - v0)
    prim_id: torch.Tensor  # (T,) i32 sorted slot -> original triangle id
    tri_tab: torch.Tensor  # (Tpad, 16) f32 packed table (pack_tri_table layout)

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]


def check_brute_size(T: int) -> None:
    if T > BRUTE_MAX_TRIS:
        raise NotImplementedError(
            f"scene has {T} triangles; the port traces at most {BRUTE_MAX_TRIS} "
            "(the brute-force tier). Larger scenes need the cluster tier, "
            "ROADMAP.md queue A slice 3."
        )


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


def build_bvh(tri_verts: np.ndarray, device, tri_normal: np.ndarray | None = None,
              tri_mesh: np.ndarray | None = None) -> BVH:
    """Build from (T, 3, 3) float32 triangle vertices into tensors on ``device``."""
    tri_verts = np.asarray(tri_verts, np.float32)
    T = tri_verts.shape[0]
    if T == 0:
        raise ValueError("empty scene")
    check_brute_size(T)

    tmin = tri_verts.min(axis=1)
    tmax = tri_verts.max(axis=1)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-20)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(morton3d(q[:, 0], q[:, 1], q[:, 2]), kind="stable").astype(np.int32)

    v0 = tri_verts[order, 0]
    e1 = tri_verts[order, 1] - v0
    e2 = tri_verts[order, 2] - v0
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    tri_tab = pack_tri_table(
        v0, e1, e2, order,
        normal=None if tri_normal is None else np.asarray(tri_normal)[order],
        mesh_id=None if tri_mesh is None else np.asarray(tri_mesh)[order],
        area=area,
    )
    return bvh_from_numpy({"tri_tab": tri_tab, "tri_v0": v0, "tri_e1": e1, "tri_e2": e2, "prim_id": order},
                          device)


def bvh_from_numpy(arrs: dict, device) -> BVH:
    """Upload brute-tier build products as numpy arrays: the JAX package's
    ``build_bvh(..., _as_arrays=True)`` (extra keys are ignored)."""
    tri_tab = np.asarray(arrs["tri_tab"], np.float32)
    check_brute_size(np.asarray(arrs["tri_v0"]).shape[0])
    if tri_tab.ndim != 2 or tri_tab.shape[1] != 16 or tri_tab.shape[0] % TRI_SUB:
        raise ValueError(f"tri_tab must be the flat (Tpad, 16) brute-tier table, got {tri_tab.shape}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return BVH(
        tri_v0=f32(arrs["tri_v0"]),
        tri_e1=f32(arrs["tri_e1"]),
        tri_e2=f32(arrs["tri_e2"]),
        prim_id=torch.tensor(np.asarray(arrs["prim_id"], np.int32), device=device),
        tri_tab=f32(tri_tab),
    )
