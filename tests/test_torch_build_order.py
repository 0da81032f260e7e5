"""The cluster tier's triangle order (``accel.build.median_split_order``):
a top-down object-median split of the centroids, cut into the same fixed
runs of 64 triangles (a cluster) and 64 clusters (a supercluster).

Held on three scenes: SPD's tetra at depth 7 with its light (65,538
triangles, two meshes), the grid-100 terrain inside the Cornell walls
(19,614 triangles, several meshes) and the depth-6 tetra alone (16,384
triangles, one mesh, built from its numpy arrays): ``prim_id`` is a
permutation; every node of the split puts the centroids of its first half
on one side of its cut, on the longest axis of its centroid box, so every
cluster but the last and every supercluster off the split's right edge is
a node; two builds are byte-equal; the cache reads no entry of the Morton
build (tag v1); and the summed cluster and supercluster box areas
(``cluster_area_ratio``) are below those of the Morton runs, computed here
from the same triangles.  No JAX: the brute tier's byte equality with the
JAX build is ``tests/test_torch_trace.py``'s.
"""

import types

import numpy as np
import pytest
import torch

from optix_renderer_tpu_torch.accel import build
from optix_renderer_tpu_torch.engine.renderer import bvh_inputs
from optix_renderer_tpu_torch.scene import parse_scene, write_spd_tetra_scene, write_terrain_scene
from optix_renderer_tpu_torch.scene.device import build_device_scene
from optix_renderer_tpu_torch.scene.procedural import spd_tetra_mesh

torch.set_num_threads(2)

SCENES = ["tetra7", "terrain100", "tetra6_one_mesh"]
SC_ROWS = build.CLUSTER_SIZE * build.SC_GROUP


def _one_mesh_inputs(depth: int):
    """(tri_verts, build kwargs) of the tetra's triangles as one mesh."""
    verts, faces = spd_tetra_mesh(depth)
    tri = verts[faces].astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(n, axis=-1)
    n = (n / np.maximum(2.0 * area[:, None], 1e-20)).astype(np.float32)
    mesh = np.zeros(len(tri), np.int32)
    attr = build.pack_attr_tab(np.repeat(n[:, None], 3, axis=1), np.zeros((len(tri), 3, 2), np.float32), mesh, area)
    return tri, {"tri_normal": n, "tri_mesh": mesh, "tri_attr": attr}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each scene's ``build_bvh`` inputs and its build products."""
    out = {}
    for name in SCENES:
        if name == "tetra6_one_mesh":
            tri_verts, kw = _one_mesh_inputs(6)
        else:
            d = str(tmp_path_factory.mktemp(name))
            path = write_spd_tetra_scene(d, depth=7) if name == "tetra7" else write_terrain_scene(d, grid=100)
            tri_verts, kw = bvh_inputs(build_device_scene(parse_scene(path), torch.device("cpu"))[1])
        out[name] = (tri_verts, kw, build.build_bvh_arrays(tri_verts, **kw))
    return out


def _centroids(tri_verts):
    return 0.5 * (tri_verts.min(axis=1) + tri_verts.max(axis=1))


def _nodes(T: int):
    """The split's inner nodes (lo, mid, hi) over rows [0, T)."""
    stack, nodes = [(0, T)], []
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= build.CLUSTER_SIZE:
            continue
        mid = lo + build.split_size(hi - lo)
        nodes.append((lo, mid, hi))
        stack += [(lo, mid), (mid, hi)]
    return nodes


@pytest.mark.parametrize("n, k", [(65, 64), (127, 64), (128, 64), (200, 128), (4102, 2048), (8192, 4096),
                                  (8193, 4096), (12288, 8192), (16384, 8192), (20000, 8192),
                                  (1048582, 524288)])
def test_split_size(n, k):
    """A multiple of 4,096 above 8,192 triangles, else of 64, nearest n / 2."""
    assert build.split_size(n) == k


@pytest.mark.parametrize("scene", SCENES)
def test_prim_id_is_a_permutation(inputs, scene):
    tri_verts, _, arrs = inputs[scene]
    T = tri_verts.shape[0]
    assert T > build.BRUTE_MAX_TRIS
    np.testing.assert_array_equal(np.sort(arrs["prim_id"]), np.arange(T))
    np.testing.assert_array_equal(arrs["tri_v0"], tri_verts[arrs["prim_id"], 0])
    np.testing.assert_array_equal(arrs["shade_a"][:T, 19], arrs["prim_id"].astype(np.float32))


@pytest.mark.parametrize("scene", SCENES)
def test_every_cluster_is_a_node_of_the_split(inputs, scene):
    """Each node's first half lies on one side of its cut on the longest
    axis of its centroid box (the lowest of equal ones), so each node's
    rows are cut off from its ancestors' other halves; the nodes hold
    every full cluster but the last and every supercluster whose next one
    is full too."""
    tri_verts, _, arrs = inputs[scene]
    T = tri_verts.shape[0]
    c = _centroids(tri_verts)[arrs["prim_id"]]
    nodes = _nodes(T)
    for lo, mid, hi in nodes:
        ext = c[lo:hi].max(axis=0) - c[lo:hi].min(axis=0)
        axis = int(np.flatnonzero(ext == ext.max())[0])
        assert c[lo:mid, axis].max() <= c[mid:hi, axis].min(), (lo, mid, hi, axis)
    ranges = {(lo, mid) for lo, mid, _ in nodes} | {(mid, hi) for _, mid, hi in nodes}
    C = -(-T // build.CLUSTER_SIZE)
    for cl in range(C - 1):
        assert (cl * build.CLUSTER_SIZE, (cl + 1) * build.CLUSTER_SIZE) in ranges, cl
    full_sc = [s for s in range(T // SC_ROWS) if (s + 2) * SC_ROWS <= T]
    assert full_sc or T < 2 * SC_ROWS
    for s in full_sc:
        assert (s * SC_ROWS, (s + 1) * SC_ROWS) in ranges, s


@pytest.mark.parametrize("scene", SCENES)
def test_two_builds_are_byte_equal(inputs, scene):
    tri_verts, kw, arrs = inputs[scene]
    again = build.build_bvh_arrays(tri_verts, **kw)
    assert sorted(again) == sorted(arrs)
    for k, a in arrs.items():
        assert a.dtype == again[k].dtype and a.shape == again[k].shape and a.tobytes() == again[k].tobytes(), k


def _boxes(cmin, cmax):
    """What ``cluster_area_ratio`` reads of a BVH: its cluster and supercluster boxes."""
    return types.SimpleNamespace(cluster_min=cmin, cluster_max=cmax, **dict(zip(
        ("sc_min", "sc_max"), build.supercluster_boxes(cmin, cmax))))


def _morton_area_ratio(tri_verts):
    """``cluster_area_ratio`` of fixed runs of the Morton order itself."""
    T = tri_verts.shape[0]
    tmin, tmax = tri_verts.min(axis=1), tri_verts.max(axis=1)
    c = 0.5 * (tmin + tmax)
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = np.clip(((c - lo) / np.maximum(hi - lo, 1e-20)) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(build.morton3d(q[:, 0], q[:, 1], q[:, 2]), kind="stable")
    C = -(-T // build.CLUSTER_SIZE)
    cid = np.arange(T) // build.CLUSTER_SIZE
    cmin, cmax = np.full((C, 3), np.inf, np.float32), np.full((C, 3), -np.inf, np.float32)
    np.minimum.at(cmin, cid, tmin[order])
    np.maximum.at(cmax, cid, tmax[order])
    return build.cluster_area_ratio(_boxes(torch.tensor(cmin), torch.tensor(cmax)))


@pytest.mark.parametrize("scene", ["tetra7", "terrain100"])
def test_cluster_boxes_are_tighter_than_morton_runs(inputs, scene):
    tri_verts, _, arrs = inputs[scene]
    ours = build.cluster_area_ratio(build.bvh_from_numpy(arrs, "cpu"))
    morton = _morton_area_ratio(tri_verts)
    assert ours[0] < morton[0] and ours[1] < morton[1], (ours, morton)


def test_cluster_area_ratio_by_hand():
    """Two unit cubes side by side: 12 over the 2 x 1 x 1 box's 10, and one
    supercluster with the scene's box."""
    cmin = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    cmax = torch.tensor([[1.0, 1.0, 1.0], [2.0, 1.0, 1.0]])
    assert build.cluster_area_ratio(_boxes(cmin, cmax)) == pytest.approx((1.2, 1.0), rel=1e-12)


def test_cache_reads_no_entry_of_the_morton_build(inputs, tmp_path, monkeypatch):
    """An entry under the previous tag's key is never read: the same
    inputs build anew under another name."""
    tri_verts, kw, arrs = inputs["terrain100"]
    assert build._CACHE_TAG.endswith(b"-v2")
    with monkeypatch.context() as m:
        m.setattr(build, "_CACHE_TAG", b"optix_renderer_tpu_torch-bvh-v1")
        old = tmp_path / f"{build._CACHE_PREFIX}{build.bvh_cache_key(tri_verts, **kw)}.npz"
    np.savez(old, **{k: np.zeros_like(a) for k, a in arrs.items()})  # an entry that would read as empty boxes
    got = build.build_bvh_cached(str(tmp_path), tri_verts, "cpu", **kw)
    new = tmp_path / f"{build._CACHE_PREFIX}{build.bvh_cache_key(tri_verts, **kw)}.npz"
    assert new != old and new.exists()
    np.testing.assert_array_equal(got.cluster_min.numpy(), arrs["cluster_min"])
    np.testing.assert_array_equal(got.prim_id.numpy(), arrs["prim_id"])
