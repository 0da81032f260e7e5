"""Device scene: flat SoA tensors uploaded once per scene.

Counterpart of ``optix_renderer_tpu/scene/device.py``: one globally indexed
geometry pool plus per-mesh material and light tables, on an explicit
``device``.  Traversal returns a triangle id; shading gathers the packed
per-triangle row ``tri_pack[tri_id]`` (layout ``PACK_SLICES``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Scene

# largest scene (tris) whose shading reads the packed per-triangle rows
ONEHOT_MAX_TRIS = 4096

# the miss program's constant color (common.cuh:153-155)
MISS_COLOR = (0.0, 0.0, 0.0)

# tri_pack column layout (end-exclusive)
PACK_SLICES = {
    "v1": (0, 3), "v2": (3, 6), "v3": (6, 9),
    "n1": (9, 12), "n2": (12, 15), "n3": (15, 18),
    "uv1": (18, 20), "uv2": (20, 22), "uv3": (22, 24),
    "diffuse": (24, 27), "emit": (27, 30),
    "alpha": (30, 31), "is_light": (31, 32), "material_id": (32, 33),
    "area": (33, 34), "diffuse_tex": (34, 35),
}
PACK_K = 35


@dataclasses.dataclass
class TextureAtlas:
    """All textures packed into one flat pixel pool; bilinear filtering is
    explicit gathers (scene.textures.sample_bilinear)."""

    pixels: torch.Tensor  # (P, 4) float32 in [0,1], row-major per texture, row 0 = bottom
    offset: torch.Tensor  # (K,) int32 start of texture k in pixels
    width: torch.Tensor  # (K,) int32
    height: torch.Tensor  # (K,) int32


@dataclasses.dataclass
class DeviceScene:
    """Flat scene pool + light lists + material tables (see the JAX
    package's DeviceScene for each field's meaning)."""

    vertices: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor  # (V, 3) f32
    uvs: torch.Tensor  # (V, 2) f32
    tri_index: torch.Tensor  # (T, 3) i32
    tri_mesh: torch.Tensor  # (T,) i32

    mesh_diffuse: torch.Tensor  # (M, 3)
    mesh_alpha: torch.Tensor  # (M,)
    mesh_emit: torch.Tensor  # (M, 3)
    mesh_is_light: torch.Tensor  # (M,) bool
    mesh_material_id: torch.Tensor  # (M,) i32
    mesh_diffuse_tex: torch.Tensor  # (M,) i32 atlas id or -1
    mesh_alpha_tex: torch.Tensor  # (M,) i32
    mesh_normal_tex: torch.Tensor  # (M,) i32

    light_v1: torch.Tensor  # (L, 3)
    light_v2: torch.Tensor  # (L, 3)
    light_v3: torch.Tensor  # (L, 3)
    light_cg: torch.Tensor  # (L, 3)
    light_normal: torch.Tensor  # (L, 3)
    light_emit: torch.Tensor  # (L, 3)
    light_area: torch.Tensor  # (L,)

    mesh_light_tri_idx: torch.Tensor  # (ML,) i32
    mesh_light_tri_count: torch.Tensor  # (ML,) i32

    textures: TextureAtlas
    miss_color: torch.Tensor  # (3,)

    tri_pack: torch.Tensor  # (T, PACK_K) f32, layout PACK_SLICES

    @property
    def num_tris(self) -> int:
        return self.tri_index.shape[0]

    @property
    def has_textures(self) -> bool:
        """Any real texture in the atlas (shape-based, no device read)?"""
        return self.textures.pixels.shape[0] > 1

    @property
    def num_lights(self) -> int:
        return self.light_v1.shape[0]


_BOOL_FIELDS = ("mesh_is_light",)
_INT_FIELDS = (
    "tri_index", "tri_mesh", "mesh_material_id", "mesh_diffuse_tex",
    "mesh_alpha_tex", "mesh_normal_tex", "mesh_light_tri_idx", "mesh_light_tri_count",
)
_TEX_INT_FIELDS = ("offset", "width", "height")


def _upload(name: str, a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` in the field's dtype (bool, int32 or f32)."""
    if name in _BOOL_FIELDS:
        dtype = bool
    elif name in _INT_FIELDS or name in _TEX_INT_FIELDS:
        dtype = np.int32
    else:
        dtype = np.float32
    return torch.tensor(np.asarray(a, dtype=dtype), device=device)


def device_scene_from_numpy(fields: dict, device) -> DeviceScene:
    """A DeviceScene from the JAX package's DeviceScene fields as numpy
    arrays: ``textures`` is a dict of the atlas' four fields."""
    tex = fields["textures"]
    atlas = TextureAtlas(**{k: _upload(k, tex[k], device) for k in ("pixels", "offset", "width", "height")})
    names = [f.name for f in dataclasses.fields(DeviceScene) if f.name != "textures"]
    return DeviceScene(textures=atlas, **{k: _upload(k, fields[k], device) for k in names})


def _texture_fields(textures) -> dict:
    if not textures:
        return dict(
            pixels=np.ones((1, 4), np.float32),
            offset=np.zeros((1,), np.int32),
            width=np.ones((1,), np.int32),
            height=np.ones((1,), np.int32),
        )
    offsets, widths, heights, pools = [], [], [], []
    off = 0
    for t in textures:
        h, w = t.pixels.shape[:2]
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        pools.append(t.pixels.reshape(-1, 4))
        off += h * w
    return dict(
        pixels=np.concatenate(pools, axis=0),
        offset=np.asarray(offsets),
        width=np.asarray(widths),
        height=np.asarray(heights),
    )


def build_device_scene(scene: Scene, device) -> tuple[DeviceScene, dict]:
    """Flatten a host Scene into tensors on ``device``.

    The same host arithmetic as the JAX package's ``build_device_scene``
    (light list per viewer.hpp:236-265).  Returns the DeviceScene and the
    flat numpy geometry {vertices, normals, uvs, tri_index, tri_mesh} that
    the BVH builder consumes.
    """
    meshes = scene.model.meshes
    verts, norms, uvs, tris, tri_mesh = [], [], [], [], []
    v_off = 0
    for mid, m in enumerate(meshes):
        verts.append(m.vertex)
        norms.append(m.normal)
        uvs.append(m.texcoord)
        tris.append(m.index.astype(np.int64) + v_off)
        tri_mesh.append(np.full(len(m.index), mid, np.int32))
        v_off += len(m.vertex)

    lv1, lv2, lv3, lcg, lnormal, lemit, larea = [], [], [], [], [], [], []
    ml_idx, ml_count = [], []
    for light in scene.tri_lights.meshes:
        ml_idx.append(len(lv1))
        n_tri = 0
        for idx in light.index:
            v1 = light.vertex[idx[0]]
            v2 = light.vertex[idx[1]]
            v3 = light.vertex[idx[2]]
            lv1.append(v1)
            lv2.append(v2)
            lv3.append(v3)
            lcg.append((v1 + v2 + v3) / 3.0)
            n = light.normal[idx[0]] + light.normal[idx[1]] + light.normal[idx[2]]
            lnormal.append(n / max(np.linalg.norm(n), 1e-20))
            larea.append(0.5 * np.linalg.norm(np.cross(v1 - v2, v3 - v2)))
            lemit.append(light.emit)
            n_tri += 1
        ml_count.append(n_tri)

    all_v = np.concatenate(verts, axis=0)
    all_n = np.concatenate(norms, axis=0)
    all_uv = np.concatenate(uvs, axis=0)
    all_tri = np.concatenate(tris, axis=0)
    all_mesh = np.concatenate(tri_mesh, axis=0)
    mesh_diffuse = np.stack([m.diffuse for m in meshes]).astype(np.float32)
    mesh_alpha = np.asarray([m.alpha for m in meshes], np.float32)
    mesh_emit = np.stack([m.emit for m in meshes]).astype(np.float32)
    mesh_is_light = np.asarray([m.is_light for m in meshes], np.float32)
    mesh_matid = np.asarray([m.material_id for m in meshes], np.float32)
    mesh_dtex = np.asarray([m.diffuse_texture_id for m in meshes], np.float32)
    if len(all_tri) <= ONEHOT_MAX_TRIS:
        tv1, tv2, tv3 = (all_v[all_tri[:, k]] for k in range(3))
        tn1, tn2, tn3 = (all_n[all_tri[:, k]] for k in range(3))
        tu1, tu2, tu3 = (all_uv[all_tri[:, k]] for k in range(3))
        tri_area = 0.5 * np.linalg.norm(np.cross(tv1 - tv2, tv3 - tv2), axis=-1)
        tri_pack = np.concatenate(
            [
                tv1, tv2, tv3, tn1, tn2, tn3, tu1, tu2, tu3,
                mesh_diffuse[all_mesh], mesh_emit[all_mesh],
                mesh_alpha[all_mesh][:, None], mesh_is_light[all_mesh][:, None],
                mesh_matid[all_mesh][:, None], tri_area[:, None].astype(np.float32),
                mesh_dtex[all_mesh][:, None],
            ],
            axis=1,
        ).astype(np.float32)
        assert tri_pack.shape[1] == PACK_K
    else:
        tri_pack = np.zeros((1, PACK_K), np.float32)

    def stack3(rows):
        return np.stack(rows) if rows else np.zeros((0, 3))

    fields = dict(
        tri_pack=tri_pack,
        vertices=all_v,
        normals=all_n,
        uvs=all_uv,
        tri_index=all_tri,
        tri_mesh=all_mesh,
        mesh_diffuse=np.stack([m.diffuse for m in meshes]),
        mesh_alpha=np.asarray([m.alpha for m in meshes]),
        mesh_emit=np.stack([m.emit for m in meshes]),
        mesh_is_light=np.asarray([m.is_light for m in meshes], bool),
        mesh_material_id=np.asarray([m.material_id for m in meshes]),
        mesh_diffuse_tex=np.asarray([m.diffuse_texture_id for m in meshes]),
        mesh_alpha_tex=np.asarray([m.alpha_texture_id for m in meshes]),
        mesh_normal_tex=np.asarray([m.normal_texture_id for m in meshes]),
        light_v1=stack3(lv1),
        light_v2=stack3(lv2),
        light_v3=stack3(lv3),
        light_cg=stack3(lcg),
        light_normal=stack3(lnormal),
        light_emit=stack3(lemit),
        light_area=np.asarray(larea) if larea else np.zeros((0,)),
        mesh_light_tri_idx=np.asarray(ml_idx),
        mesh_light_tri_count=np.asarray(ml_count),
        textures=_texture_fields(scene.model.textures),
        miss_color=np.asarray(MISS_COLOR),
    )
    host = dict(
        vertices=all_v.astype(np.float32),
        normals=all_n.astype(np.float32),
        uvs=all_uv.astype(np.float32),
        tri_index=all_tri.astype(np.int64),
        tri_mesh=all_mesh.astype(np.int32),
    )
    return device_scene_from_numpy(fields, device), host
