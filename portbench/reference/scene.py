"""The plain reference's scene: a scene JSON and its OBJ/MTL files read into
flat numpy tables, with no code of the renderer under test.

Semantics of the reference renderer's loader (the scene JSON's
``surface_geometry`` and ``area_lights`` OBJs; faces fan-triangulated,
vertices taken per face corner, ``Kd`` the diffuse color, ``Ns`` the raw
roughness, ``Ke`` the emission; the light OBJ's triangles are traced too,
as lights).  The light list is the light OBJ's triangles in file order,
each with the normalized sum of its corner normals and its area
``0.5 |(v1 - v2) x (v3 - v2)|``, in float32 as the renderer computes them.

``load_scene`` keeps a parsed copy of each OBJ in ``cache_dir`` (keyed by
the file's path, size and modification time), since an OBJ of a million
triangles takes seconds to parse.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def _parse_mtl(path: str) -> dict:
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = mats.setdefault(tok[1], {"Kd": [0.0, 0.0, 0.0], "Ns": 0.0, "Ke": [0.0, 0.0, 0.0]})
            elif cur is not None and tok[0] in ("Kd", "Ke"):
                cur[tok[0]] = [float(x) for x in tok[1:4]]
            elif cur is not None and tok[0] == "Ns":
                cur["Ns"] = float(tok[1])
    return mats


def _corner(tok: bytes, nv: int, nn: int) -> tuple[int, int]:
    parts = tok.split(b"/")
    vi = int(parts[0])
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return (vi - 1 if vi > 0 else nv + vi), (ni - 1 if ni > 0 else (nn + ni if ni < 0 else -1))


def parse_obj(path: str) -> dict:
    """One OBJ as per-triangle arrays: ``v`` (T, 3, 3) and ``n`` (T, 3, 3)
    float32 corner positions and normals (face normals where a face gives
    none), ``material`` (T,) index into ``materials`` (name, Kd, Ns, Ke)."""
    model_dir = os.path.dirname(path)
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    pos = [ln[2:] for ln in lines if ln.startswith(b"v ")]
    nrm = [ln[3:] for ln in lines if ln.startswith(b"vn ")]
    pos = np.array(b" ".join(pos).split(), np.float64).astype(np.float32).reshape(-1, 3)
    nrm = np.array(b" ".join(nrm).split(), np.float64).astype(np.float32).reshape(-1, 3)
    mats: dict = {}
    names: list[str] = []
    vi_list: list[tuple] = []
    ni_list: list[tuple] = []
    mat_list: list[int] = []
    cur = -1
    nv = nn = 0
    for ln in lines:
        if ln.startswith(b"v "):
            nv += 1
        elif ln.startswith(b"vn "):
            nn += 1
        elif ln.startswith(b"f "):
            cs = [_corner(t, nv, nn) for t in ln.split()[1:]]
            for k in range(1, len(cs) - 1):
                vi_list.append((cs[0][0], cs[k][0], cs[k + 1][0]))
                ni_list.append((cs[0][1], cs[k][1], cs[k + 1][1]))
                mat_list.append(cur)
        elif ln.startswith(b"usemtl"):
            name = ln.split()[1].decode() if len(ln.split()) > 1 else ""
            cur = names.index(name) if name in names else -1
        elif ln.startswith(b"mtllib"):
            for name, m in _parse_mtl(os.path.join(model_dir, ln.split(maxsplit=1)[1].decode().strip())).items():
                if name not in names:
                    names.append(name)
                mats[name] = m
    vi = np.asarray(vi_list, np.int64).reshape(-1, 3)
    ni = np.asarray(ni_list, np.int64).reshape(-1, 3)
    v = pos[vi]
    if (ni >= 0).all() and len(nrm):
        n = nrm[ni]
    else:
        fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        n = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    material = np.asarray(mat_list, np.int64)
    if (material < 0).any():
        raise ValueError(f"{path}: a face has no material")
    table = [(nm, mats[nm]["Kd"], mats[nm]["Ns"], mats[nm]["Ke"]) for nm in names]
    return {"v": v, "n": n, "material": material, "materials": table}


def _cached_obj(path: str, cache_dir: str | None) -> dict:
    if cache_dir is None:
        return parse_obj(path)
    st = os.stat(path)
    key = hashlib.sha1(f"{os.path.abspath(path)}|{st.st_size}|{st.st_mtime_ns}".encode()).hexdigest()[:16]
    npz = os.path.join(cache_dir, f"ref-obj-{key}.npz")
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            mats = json.loads(str(z["materials"]))
            return {"v": z["v"], "n": z["n"], "material": z["material"], "materials": [tuple(m) for m in mats]}
    obj = parse_obj(path)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{npz}.tmp{os.getpid()}.npz"
    np.savez(tmp, v=obj["v"], n=obj["n"], material=obj["material"], materials=json.dumps(obj["materials"]))
    os.replace(tmp, npz)
    return obj


def load_scene(scene_json: str, cache_dir: str | None = None) -> dict:
    """The scene as flat float32 tables: per triangle ``v`` (T, 3, 3), ``n``
    (T, 3, 3), ``diffuse`` (T, 3), ``alpha`` (T,) (raw ``Ns``), ``emit``
    (T, 3), ``is_light`` (T,); the lights ``light_v`` (L, 3, 3),
    ``light_normal`` (L, 3), ``light_emit`` (L, 3), ``light_area`` (L,);
    and ``cameras`` [(from, to, up, cos_fovy)]."""
    with open(scene_json) as f:
        cfg = json.load(f)
    base = os.path.dirname(os.path.abspath(scene_json))
    surf = _cached_obj(os.path.join(base, cfg["surface_geometry"]), cache_dir)
    light = _cached_obj(os.path.join(base, cfg["area_lights"]), cache_dir)

    def per_tri(obj, col):
        table = np.asarray([m[col] for m in obj["materials"]], np.float32)
        return table[obj["material"]]

    lv, ln = light["v"], light["n"]
    lnorm = ln[:, 0] + ln[:, 1] + ln[:, 2]
    lnorm = np.stack([n / max(np.linalg.norm(n), 1e-20) for n in lnorm]).astype(np.float32)
    larea = np.asarray([0.5 * np.linalg.norm(np.cross(t[0] - t[1], t[2] - t[1])) for t in lv], np.float32)
    n_l = len(lv)
    return {
        "v": np.concatenate([surf["v"], lv]).astype(np.float32),
        "n": np.concatenate([surf["n"], ln]).astype(np.float32),
        "diffuse": np.concatenate([per_tri(surf, 1), per_tri(light, 1)]),
        "alpha": np.concatenate([per_tri(surf, 2), per_tri(light, 2)]),
        "emit": np.concatenate([per_tri(surf, 3), per_tri(light, 3)]),
        "is_light": np.concatenate([np.zeros(len(surf["v"]), bool), np.ones(n_l, bool)]),
        "light_v": lv.astype(np.float32),
        "light_normal": lnorm,
        "light_emit": per_tri(light, 3),
        "light_area": larea,
        "cameras": [(np.asarray(c["from"], np.float32), np.asarray(c["to"], np.float32),
                     np.asarray(c["up"], np.float32), float(c["cos_fovy"])) for c in cfg["cameras"]],
    }
