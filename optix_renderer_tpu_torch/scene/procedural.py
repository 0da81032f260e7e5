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

# three distinct area lights (multi-area-light config, BASELINE config 3):
# warm quad near the ceiling center, cool quad at the left, green strip at
# the right — different emissions exercise per-light pdf/emission pairing
_MULTI_LIGHTS = [
    ([(343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332), (213, 548.7, 227)],
     (17.0, 12.0, 4.0)),
    ([(120, 548.7, 100), (120, 548.7, 180), (40, 548.7, 180), (40, 548.7, 100)],
     (2.0, 6.0, 14.0)),
    ([(520, 548.7, 380), (520, 548.7, 460), (450, 548.7, 460), (450, 548.7, 380)],
     (3.0, 12.0, 3.0)),
]


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


def write_cornell3_scene(
    out_dir: str,
    width: int = 512,
    height: int = 512,
    spp: int = 1,
    roughness: float = 0.3,
) -> str:
    """Cornell box with THREE area lights of different emission
    (multi-area-light scene for the ratio/LTC/MIS estimators — a single
    light cannot distinguish 'sampled light' from 'hit light' semantics).
    Returns the scene JSON path."""
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

    # one light mesh per emission (per-mesh emit, viewer.hpp:236-265)
    mtl_lines = []
    quads_by_mtl = {}
    for i, (quad, emit) in enumerate(_MULTI_LIGHTS):
        name = f"light{i}"
        mtl_lines.append(
            "newmtl {}\nKd 0.780 0.780 0.780\nNs 1.0\nKe {} {} {}\n".format(name, *emit)
        )
        quads_by_mtl[name] = [quad]
    with open(os.path.join(out_dir, "light.mtl"), "w") as f:
        f.write("\n".join(mtl_lines))
    with open(os.path.join(out_dir, "light.obj"), "w") as f:
        f.write(_emit_obj(quads_by_mtl, "light.mtl"))

    scene = {
        "spp": spp,
        "width": width,
        "height": height,
        "renderers": [9],
        "cameras": [CORNELL_CAMERA],
        "surface_geometry": "cornell.obj",
        "area_lights": "light.obj",
    }
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=2)
    return path


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


# SPD ``tetra`` (Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A 7(11), 1987):
# the root's corners at alternate corners of the cube [-512, 512]^3, so that every vertex down
# to 9 subdivisions is an integer
SPD_TETRA_CORNERS = np.array([(512, 512, 512), (512, -512, -512), (-512, 512, -512), (-512, -512, 512)], np.int64)
SPD_TETRA_MAX_DEPTH = 9
# a leaf's four faces: face j leaves out corner j, wound so that (b - a) x (c - a) points away from it
SPD_TETRA_FACES = ((1, 3, 2), (0, 2, 3), (0, 3, 1), (0, 1, 2))
SPD_TETRA_CAMERA = {"from": [1485.0, 209.0, 0.0], "to": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0], "cos_fovy": 0.55}
SPD_TETRA_SIZE = 1024  # the image's width and height
# one 600 x 600 area light 588 above the top edge, towards the camera, facing down
_SPD_TETRA_LIGHT = [[(600, 1100, -300), (600, 1100, 300), (0, 1100, 300), (0, 1100, -300)]]
_SPD_TETRA_LIGHT_EMIT = (34.0, 30.0, 24.0)


def spd_tetra_mesh(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """SPD's Sierpinski tetrahedron after ``depth`` subdivisions: a
    tetrahedron replaced by four half-size copies at its corners, level
    after level.  Returns (vertices (2 * 4^depth + 2, 3) int64, numbered in
    order of first use; faces (4^(depth + 1), 3) 0-based), the 4^depth
    leaves in depth-first order (leaf k's level-l copy is base-4 digit l of
    k, most significant first), four faces each."""
    if not 0 <= depth <= SPD_TETRA_MAX_DEPTH:
        raise ValueError(f"depth {depth}: the integer grid holds 0 to {SPD_TETRA_MAX_DEPTH} subdivisions")
    leaf = np.arange(4 ** depth, dtype=np.int64)
    origin = np.zeros((leaf.size, 3), np.int64)
    for level in range(1, depth + 1):
        origin += SPD_TETRA_CORNERS[(leaf >> (2 * (depth - level))) & 3] >> level
    corners = origin[:, None, :] + (SPD_TETRA_CORNERS >> depth)[None]
    face_corners = corners[:, np.asarray(SPD_TETRA_FACES)].reshape(-1, 3)
    uniq, first, inverse = np.unique(face_corners, axis=0, return_index=True, return_inverse=True)
    by_use = np.argsort(first)
    rank = np.empty_like(by_use)
    rank[by_use] = np.arange(by_use.size)
    return uniq[by_use], rank[inverse.reshape(-1)].reshape(-1, 3)


def write_spd_tetra_scene(out_dir: str, depth: int = 9) -> str:
    """SPD's ``tetra`` at ``depth`` subdivisions (4^(depth+1) triangles:
    depth 9 gives 1,048,576) as ``tetra.obj``/``tetra.mtl`` (shared
    integer vertices, ``f a b c`` faces in depth-first order, one
    material), one area-light quad (``light.obj``/``light.mtl``) and
    ``scene.json`` with one camera.  SPD gives the geometry; the light,
    the material and the camera are this scene's own (SPD lights by
    points, its NFF surfaces are not the GGX + Lambert material, and its
    view fills about a sixth of the image with the tetra).  Returns the
    JSON path."""
    verts, faces = spd_tetra_mesh(depth)
    os.makedirs(out_dir, exist_ok=True)
    lines = [f"# SPD tetra, depth {depth}: {4 ** depth} leaf tetrahedra, {len(faces)} triangles",
             "mtllib tetra.mtl"]
    lines.extend("v %d %d %d" % tuple(v) for v in verts.tolist())
    lines.append("usemtl tetra")
    lines.extend("f %d %d %d" % tuple(f) for f in (faces + 1).tolist())
    with open(os.path.join(out_dir, "tetra.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "tetra.mtl"), "w") as f:
        f.write("newmtl tetra\nKd 0.730 0.730 0.730\nNs 0.3\n")
    with open(os.path.join(out_dir, "light.mtl"), "w") as f:
        f.write("newmtl light\nKd 0.780 0.780 0.780\nNs 1.0\nKe {} {} {}\n".format(*_SPD_TETRA_LIGHT_EMIT))
    with open(os.path.join(out_dir, "light.obj"), "w") as f:
        f.write(_emit_obj({"light": _SPD_TETRA_LIGHT}, "light.mtl"))
    scene = {"spp": 1, "width": SPD_TETRA_SIZE, "height": SPD_TETRA_SIZE, "renderers": [9],
             "cameras": [SPD_TETRA_CAMERA], "surface_geometry": "tetra.obj", "area_lights": "light.obj"}
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=2)
    return path


def _uv_sphere(center, radius, n_lat=10, n_lon=14):
    """UV-sphere with per-vertex normals + uvs; returns (v, vn, vt, faces)
    with faces as (k, 3) 0-based indices shared across v/vt/vn."""
    cx, cy, cz = center
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    LA, LO = np.meshgrid(lats, lons, indexing="ij")
    nx = np.sin(LA) * np.cos(LO)
    ny = np.cos(LA)
    nz = np.sin(LA) * np.sin(LO)
    n = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3)
    v = n * radius + np.asarray([cx, cy, cz])
    vt = np.stack([LO / (2 * np.pi), 1.0 - LA / np.pi], axis=-1).reshape(-1, 2)
    cols = n_lon + 1
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            if i > 0:
                faces.append((a, c, b))
            if i < n_lat - 1:
                faces.append((b, c, d))
    return v, n, vt, np.asarray(faces, np.int64)


def _box(center, size):
    """Axis-aligned box with face normals and per-face uvs."""
    cx, cy, cz = center
    sx, sy, sz = (s / 2.0 for s in size)
    v, n, vt, faces = [], [], [], []
    axes = [
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)), ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)), ((0, -1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)), ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
    ]
    half = np.asarray([sx, sy, sz])
    c = np.asarray([cx, cy, cz])
    for nrm, tu, tv in axes:
        nrm, tu, tv = (np.asarray(a, np.float64) for a in (nrm, tu, tv))
        base = len(v)
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            v.append(c + (nrm + du * tu + dv * tv) * half)
            n.append(nrm)
            vt.append(((du + 1) / 2.0, (dv + 1) / 2.0))
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    return (np.asarray(v), np.asarray(n, np.float64), np.asarray(vt),
            np.asarray(faces, np.int64))


def _grid_plane(origin, du, dv, n_cells, uv_scale):
    """Subdivided quad (n_cells x n_cells x 2 tris) with wrapped uvs."""
    o = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64)
    dv = np.asarray(dv, np.float64)
    g = n_cells + 1
    su = np.linspace(0.0, 1.0, g)
    sv = np.linspace(0.0, 1.0, g)
    U, V = np.meshgrid(su, sv, indexing="ij")
    v = o[None, None] + U[..., None] * du[None, None] + V[..., None] * dv[None, None]
    nrm = np.cross(du, dv)
    nrm = nrm / np.linalg.norm(nrm)
    n = np.broadcast_to(nrm, (g, g, 3))
    vt = np.stack([U * uv_scale, V * uv_scale], axis=-1)
    i0 = (np.arange(n_cells)[:, None] * g + np.arange(n_cells)[None, :]).reshape(-1)
    quads = np.stack([i0, i0 + g, i0 + g + 1, i0 + 1], axis=-1)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)
    return v.reshape(-1, 3), n.reshape(-1, 3).copy(), vt.reshape(-1, 2), faces


def _write_gallery_textures(out_dir: str) -> list[str]:
    """Four deterministic diffuse maps of different sizes (PNG via PIL)."""
    from PIL import Image

    def save(name, arr):
        img = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
        img.save(os.path.join(out_dir, name))
        return name

    names = []
    # checker 128x128
    y, x = np.mgrid[0:128, 0:128]
    c = ((x // 16 + y // 16) % 2).astype(np.float32)
    checker = np.stack([0.85 * c + 0.12, 0.8 * c + 0.1, 0.75 * c + 0.1], axis=-1)
    names.append(save("tex_checker.png", checker))
    # stripes 96x64
    y, x = np.mgrid[0:96, 0:64]
    s = (np.sin(x * np.pi / 8.0) * 0.5 + 0.5).astype(np.float32)
    stripes = np.stack([0.2 + 0.7 * s, 0.5 * s + 0.1, 0.8 - 0.6 * s], axis=-1)
    names.append(save("tex_stripes.png", stripes))
    # radial gradient 200x200
    y, x = np.mgrid[0:200, 0:200]
    r = np.sqrt((x / 199.0 - 0.5) ** 2 + (y / 199.0 - 0.5) ** 2) * 2.0
    grad = np.stack([1.0 - 0.8 * r, 0.3 + 0.5 * r, 0.25 * np.ones_like(r)], axis=-1)
    names.append(save("tex_radial.png", grad.astype(np.float32)))
    # dots 64x64
    y, x = np.mgrid[0:64, 0:64]
    d = (((x % 16 - 8) ** 2 + (y % 16 - 8) ** 2) < 20).astype(np.float32)
    dots = np.stack([0.9 - 0.7 * d, 0.85 - 0.2 * d, 0.2 + 0.6 * d], axis=-1)
    names.append(save("tex_dots.png", dots))
    return names


def write_gallery_scene(
    out_dir: str,
    width: int = 512,
    height: int = 512,
    spp: int = 4,
    sphere_grid: int = 4,
) -> str:
    """Multi-mesh, multi-texture, multi-light "gallery" (VERDICT r2 item 6:
    exercises the texture atlas with K>1 textures, per-material mesh split,
    smooth normals and mixed roughness in one real render — the workload
    Model.cpp:164-242's loader exists for).

    Contents: a checker floor + textured back wall (subdivided, wrapped
    uvs), a sphere_grid^2 grid of smooth UV-spheres on box pedestals with
    textures/plain colors and Ns varying per object, and THREE area lights
    of different emission.  Default: 26 meshes, 4 textures, ~8.5k
    triangles (cluster tier on TPU).  Returns the scene JSON path.
    """
    os.makedirs(out_dir, exist_ok=True)
    tex_names = _write_gallery_textures(out_dir)

    # materials: 4 textured + 4 plain, roughness sweep
    mtl_lines = []
    mat_names = []
    for i, t in enumerate(tex_names):
        name = f"tex{i}"
        ns = (0.08, 0.25, 0.45, 0.7)[i]
        mtl_lines.append(f"newmtl {name}\nKd 1.0 1.0 1.0\nNs {ns}\nmap_Kd {t}\n")
        mat_names.append(name)
    plains = [(0.7, 0.25, 0.2), (0.2, 0.6, 0.3), (0.25, 0.3, 0.75), (0.75, 0.7, 0.25)]
    for i, kd in enumerate(plains):
        name = f"plain{i}"
        ns = (0.12, 0.3, 0.55, 0.85)[i]
        mtl_lines.append(
            "newmtl {}\nKd {:.3f} {:.3f} {:.3f}\nNs {}\n".format(name, *kd, ns)
        )
        mat_names.append(name)
    mtl_lines.append("newmtl floor\nKd 1.0 1.0 1.0\nNs 0.35\nmap_Kd tex_checker.png\n")
    mtl_lines.append("newmtl wall\nKd 1.0 1.0 1.0\nNs 0.6\nmap_Kd tex_stripes.png\n")
    mtl_lines.append("newmtl pedestal\nKd 0.55 0.55 0.58\nNs 0.4\n")
    with open(os.path.join(out_dir, "gallery.mtl"), "w") as f:
        f.write("\n".join(mtl_lines))

    # geometry: every object is its own `o` group + usemtl run, so the
    # loader's per-(shape, material) split yields one mesh per object
    v_lines, vt_lines, vn_lines, f_chunks = [], [], [], []
    v_off = [0]
    obj_id = [0]

    def emit(mtl, v, n, vt, faces):
        f_chunks.append(f"o obj{obj_id[0]}")
        obj_id[0] += 1
        f_chunks.append(f"usemtl {mtl}")
        for p in v:
            v_lines.append("v {:.4f} {:.4f} {:.4f}".format(*p))
        for p in vt:
            vt_lines.append("vt {:.5f} {:.5f}".format(*p))
        for p in n:
            vn_lines.append("vn {:.5f} {:.5f} {:.5f}".format(*p))
        base = v_off[0]
        for a, b, c in faces + 1 + base:
            f_chunks.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
        v_off[0] += len(v)

    # room: floor 520x520 at y=0, back wall
    emit("floor", *_grid_plane((0, 0, 0), (520, 0, 0), (0, 0, 520), 24, 6.0))
    emit("wall", *_grid_plane((0, 0, 520), (520, 0, 0), (0, 400, 0), 12, 4.0))

    # sphere grid on pedestals
    k = 0
    for gi in range(sphere_grid):
        for gj in range(sphere_grid):
            cx = 90 + gi * (360 / max(sphere_grid - 1, 1))
            cz = 90 + gj * (360 / max(sphere_grid - 1, 1))
            mat = mat_names[k % len(mat_names)]
            emit("pedestal", *_box((cx, 20, cz), (56, 40, 56)))
            emit(mat, *_uv_sphere((cx, 68, cz), 28.0, n_lat=10, n_lon=14))
            k += 1

    obj = ["mtllib gallery.mtl"] + v_lines + vt_lines + vn_lines + f_chunks
    with open(os.path.join(out_dir, "gallery.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")

    # three area lights of different emission near the ceiling
    light_quads = [
        ([(200, 380, 180), (200, 380, 260), (120, 380, 260), (120, 380, 180)],
         (16.0, 12.0, 6.0)),
        ([(420, 380, 180), (420, 380, 260), (340, 380, 260), (340, 380, 180)],
         (4.0, 8.0, 16.0)),
        ([(310, 380, 380), (310, 380, 450), (230, 380, 450), (230, 380, 380)],
         (6.0, 14.0, 6.0)),
    ]
    lm_lines, quads_by_mtl = [], {}
    for i, (quad, emitc) in enumerate(light_quads):
        name = f"light{i}"
        lm_lines.append(
            "newmtl {}\nKd 0.780 0.780 0.780\nNs 1.0\nKe {} {} {}\n".format(name, *emitc)
        )
        quads_by_mtl[name] = [quad]
    with open(os.path.join(out_dir, "light.mtl"), "w") as f:
        f.write("\n".join(lm_lines))
    with open(os.path.join(out_dir, "light.obj"), "w") as f:
        f.write(_emit_obj(quads_by_mtl, "light.mtl"))

    scene = {
        "spp": spp,
        "width": width,
        "height": height,
        "renderers": [9],
        "cameras": [
            {
                "from": [260.0, 300.0, -430.0],
                "to": [260.0, 80.0, 260.0],
                "up": [0.0, 1.0, 0.0],
                "cos_fovy": 0.66,
            }
        ],
        "surface_geometry": "gallery.obj",
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
