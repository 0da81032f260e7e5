"""Procedural test scenes (Cornell box and variants).

The reference ships no scene assets (its JSON path is hardcoded to the
author's machine, src/hostCode.cpp:14-15), so the framework generates the
classic Cornell box — OBJ + MTL + separate area-light OBJ + scene JSON in
exactly the schema ``scene.config`` consumes.  Used by tests and by
``scenes/`` asset generation; BASELINE configs 1-4 render this scene.
"""

from __future__ import annotations

import json
import os

import numpy as np

# classic Cornell box quads (y-up, millimetre-ish units)
_WHITE_QUADS = [
    # floor
    [(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)],
    # ceiling
    [(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)],
    # back wall
    [(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)],
    # short block
    [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
    [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
    [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
    [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
    [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
    # tall block
    [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
    [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
    [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
    [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
    [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
]
_GREEN_QUADS = [[(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)]]
_RED_QUADS = [[(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)]]
_LIGHT_QUADS = [[(343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332), (213, 548.7, 227)]]

CORNELL_CAMERA = {
    "from": [278.0, 273.0, -800.0],
    "to": [278.0, 273.0, 279.6],
    "up": [0.0, 1.0, 0.0],
    "cos_fovy": 0.66,
}

def _face_normal(q):
    v0, v1, v2 = (np.asarray(q[i], np.float64) for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    return n / np.linalg.norm(n)


def _emit_obj(quads_by_mtl: dict[str, list], mtllib: str) -> str:
    """Serialize quads (with per-face normals) as an OBJ string."""
    out = [f"mtllib {mtllib}"]
    v_lines, vn_lines, f_chunks = [], [], []
    v_count, n_count = 0, 0
    for mtl, quads in quads_by_mtl.items():
        f_chunks.append(f"usemtl {mtl}")
        for q in quads:
            n = _face_normal(q)
            vn_lines.append("vn {:.6f} {:.6f} {:.6f}".format(*n))
            n_count += 1
            ids = []
            for p in q:
                v_lines.append("v {:.4f} {:.4f} {:.4f}".format(*p))
                v_count += 1
                ids.append(v_count)
            f_chunks.append(
                "f " + " ".join(f"{i}//{n_count}" for i in ids)
            )
    return "\n".join(out + v_lines + vn_lines + f_chunks) + "\n"



def write_terrain_scene(
    out_dir: str,
    grid: int = 708,
    width: int = 1024,
    height: int = 1024,
    spp: int = 1,
    light_emit=(17.0, 12.0, 4.0),
) -> str:
    """Sponza-class stress scene (BASELINE config 5): a rolling heightfield
    of ``2*(grid-1)^2`` triangles (grid=708 -> ~1M) inside the Cornell
    walls, lit by the Cornell area light.  Shared-vertex OBJ with smooth
    per-vertex normals — exercises the loader, the clustered traversal
    tier, and the LBVH build at production scale.  Returns the JSON path.
    """
    os.makedirs(out_dir, exist_ok=True)
    g = grid
    x = np.linspace(0.0, 556.0, g, dtype=np.float64)
    z = np.linspace(0.0, 559.2, g, dtype=np.float64)
    X, Z = np.meshgrid(x, z, indexing="ij")
    # deterministic rolling hills (a few incommensurate sines)
    Y = (
        60.0
        + 38.0 * np.sin(X * 0.021) * np.cos(Z * 0.017)
        + 22.0 * np.sin(X * 0.061 + 1.3) * np.sin(Z * 0.043 + 0.7)
        + 9.0 * np.cos(X * 0.131 + 0.2) * np.sin(Z * 0.113 + 2.1)
    )
    # analytic gradient -> smooth vertex normals
    dYdX = (
        38.0 * 0.021 * np.cos(X * 0.021) * np.cos(Z * 0.017)
        + 22.0 * 0.061 * np.cos(X * 0.061 + 1.3) * np.sin(Z * 0.043 + 0.7)
        - 9.0 * 0.131 * np.sin(X * 0.131 + 0.2) * np.sin(Z * 0.113 + 2.1)
    )
    dYdZ = (
        -38.0 * 0.017 * np.sin(X * 0.021) * np.sin(Z * 0.017)
        + 22.0 * 0.043 * np.sin(X * 0.061 + 1.3) * np.cos(Z * 0.043 + 0.7)
        + 9.0 * 0.113 * np.cos(X * 0.131 + 0.2) * np.cos(Z * 0.113 + 2.1)
    )
    n = np.stack([-dYdX, np.ones_like(Y), -dYdZ], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    norms = n.reshape(-1, 3)
    # two triangles per cell, CCW seen from +y
    i0 = (np.arange(g - 1)[:, None] * g + np.arange(g - 1)[None, :]).reshape(-1)
    quads = np.stack([i0, i0 + g, i0 + g + 1, i0 + 1], axis=-1)  # (Q, 4)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0) + 1

    lines = ["mtllib terrain.mtl"]
    lines.extend("v %.4f %.4f %.4f" % tuple(v) for v in verts)
    lines.extend("vn %.6f %.6f %.6f" % tuple(v) for v in norms)
    lines.append("usemtl terrain")
    lines.extend("f %d//%d %d//%d %d//%d" % (a, a, b, b, c, c) for a, b, c in tris)

    # Cornell shell (walls only; the terrain replaces the blocks)
    shell = {"white": _WHITE_QUADS[:3], "green": _GREEN_QUADS, "red": _RED_QUADS}
    v_base = len(verts)
    n_base = len(norms)
    vcnt, ncnt = 0, 0
    for mtl, quads_ in shell.items():
        lines.append(f"usemtl {mtl}")
        for q in quads_:
            fn = _face_normal(q)
            ncnt += 1
            lines.append("vn {:.6f} {:.6f} {:.6f}".format(*fn))
            ids = []
            for p in q:
                vcnt += 1
                lines.append("v {:.4f} {:.4f} {:.4f}".format(*p))
                ids.append(v_base + vcnt)
            lines.append("f " + " ".join(f"{i}//{n_base + ncnt}" for i in ids))

    with open(os.path.join(out_dir, "terrain.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    mtl = (
        "newmtl terrain\nKd 0.560 0.540 0.460\nNs 0.45\n\n"
        "newmtl white\nKd 0.730 0.730 0.730\nNs 0.3\n\n"
        "newmtl red\nKd 0.650 0.050 0.050\nNs 0.3\n\n"
        "newmtl green\nKd 0.120 0.450 0.150\nNs 0.3\n"
    )
    with open(os.path.join(out_dir, "terrain.mtl"), "w") as f:
        f.write(mtl)

    light_mtl = "newmtl light\nKd 0.780 0.780 0.780\nNs 1.0\nKe {} {} {}\n".format(*light_emit)
    with open(os.path.join(out_dir, "light.mtl"), "w") as f:
        f.write(light_mtl)
    with open(os.path.join(out_dir, "light.obj"), "w") as f:
        f.write(_emit_obj({"light": _LIGHT_QUADS}, "light.mtl"))

    scene = {
        "spp": spp,
        "width": width,
        "height": height,
        "renderers": [9],
        "cameras": [
            {
                "from": [278.0, 380.0, -700.0],
                "to": [278.0, 120.0, 279.6],
                "up": [0.0, 1.0, 0.0],
                "cos_fovy": 0.66,
            }
        ],
        "surface_geometry": "terrain.obj",
        "area_lights": "light.obj",
    }
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=2)
    return path


def write_cornell_scene(
    out_dir: str,
    width: int = 512,
    height: int = 512,
    spp: int = 1,
    light_emit=(17.0, 12.0, 4.0),
    roughness: float = 0.3,
) -> str:
    """Write cornell.obj/mtl, light.obj/mtl, scene.json; return JSON path."""
    os.makedirs(out_dir, exist_ok=True)

    mtl = (
        "newmtl white\nKd 0.730 0.730 0.730\nNs {r}\n\n"
        "newmtl red\nKd 0.650 0.050 0.050\nNs {r}\n\n"
        "newmtl green\nKd 0.120 0.450 0.150\nNs {r}\n"
    ).format(r=roughness)
    with open(os.path.join(out_dir, "cornell.mtl"), "w") as f:
        f.write(mtl)
    obj = _emit_obj(
        {"white": _WHITE_QUADS, "green": _GREEN_QUADS, "red": _RED_QUADS}, "cornell.mtl"
    )
    with open(os.path.join(out_dir, "cornell.obj"), "w") as f:
        f.write(obj)

    light_mtl = "newmtl light\nKd 0.780 0.780 0.780\nNs 1.0\nKe {} {} {}\n".format(*light_emit)
    with open(os.path.join(out_dir, "light.mtl"), "w") as f:
        f.write(light_mtl)
    with open(os.path.join(out_dir, "light.obj"), "w") as f:
        f.write(_emit_obj({"light": _LIGHT_QUADS}, "light.mtl"))

    scene = {
        "spp": spp,
        "width": width,
        "height": height,
        "renderers": [9],  # PATH (common.cuh:17-29 enum)
        "cameras": [CORNELL_CAMERA],
        "surface_geometry": "cornell.obj",
        "area_lights": "light.obj",
    }
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=2)
    return path
