"""Native (C++) components: runtime pieces the reference implements in
C++ get native equivalents here (SURVEY §2: tinyobj-scale loading).

The shared library builds on demand with the system compiler into the
package's ``_build/`` (keyed by a hash of the source, written with an
atomic rename so concurrent processes see all or nothing); everything has
a pure-Python fallback, so the package works without a toolchain (set
``OPTIX_TPU_NO_NATIVE=1`` to force the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "objparse.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_lib = None
_tried = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"objparse-{h}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *_CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except Exception:
        return False


def get_objparse():
    """ctypes handle to the native OBJ parser, or None (fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("OPTIX_TPU_NO_NATIVE"):
        return None
    so = _library_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.obj_count.restype = ctypes.c_int
    lib.obj_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.obj_parse.restype = ctypes.c_int
    lib.obj_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    _lib = lib
    return _lib


def parse_obj_native(path: str):
    """Parse OBJ geometry natively.

    Returns (positions (P,3) f32, normals (N,3) f32, texcoords (T,2) f32,
    tri_idx (F,3,3) i32 [vi,ti,ni per corner], tri_mtl (F,) i32 indices
    into usemtl_names, tri_shape (F,) i32, usemtl_names list[str],
    mtllibs list[str]) or None when the native tier is unavailable.
    """
    lib = get_objparse()
    if lib is None:
        return None
    counts = (ctypes.c_int64 * 6)()
    if lib.obj_count(path.encode(), counts) != 0:
        return None
    np_, nn, nt, ntri, names_len, mtl_len = (int(c) for c in counts)
    pos = np.empty((np_, 3), np.float32)
    nrm = np.empty((nn, 3), np.float32)
    tex = np.empty((nt, 2), np.float32)
    tri_idx = np.empty((ntri, 3, 3), np.int32)
    tri_mtl = np.empty((ntri,), np.int32)
    tri_shape = np.empty((ntri,), np.int32)
    names = ctypes.create_string_buffer(names_len + 1)
    mtls = ctypes.create_string_buffer(mtl_len + 1)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.obj_parse(path.encode(), fp(pos), fp(nrm), fp(tex),
                       ip(tri_idx), ip(tri_mtl), ip(tri_shape), names, mtls)
    if rc != 0:
        return None
    usemtl = names.value.decode(errors="replace").split("\n") if names_len else []
    mtllibs = mtls.value.decode(errors="replace").split("\n") if mtl_len else []
    return pos, nrm, tex, tri_idx, tri_mtl, tri_shape, usemtl, mtllibs
