"""Brute-force trace kernels B1 (closest hit) and B2 (occlusion).

Counterpart of ``optix_renderer_tpu/accel/pallas_trace.py``.  Each kernel
has two pieces here:

* the wrapper (``trace_closest_cuda`` / ``trace_any_cuda``), which checks
  its inputs, allocates the outputs and launches the hand-written CUDA
  kernel in ``csrc/brute_trace.cu`` on the current stream, counting each
  launch in ``LAUNCHES``.  The kernel writes every output element once:
  the miss result of a ray with ``t_max <= 0`` (or NaN) before the row
  loop, which only the other rays enter;
* the plain PyTorch version (``trace_closest_plain`` / ``trace_any_plain``)
  with the TPU kernel's semantics: 8-row chunks, no-cull Moller-Trumbore,
  argmin inside a chunk and strict ``<`` across chunks, so the lowest
  table row wins among equal t.

``accel.traverse`` picks one of the two by the tensors' device.

All take the packed (Tpad, 16) table (``accel.build.pack_tri_table``),
origin and direction (N, 3) f32 and a per-ray t_max (N,) f32.  On a miss,
t is t_max, the id -1 and u = v = 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.launches import count_launch
from .build import TRI_SUB  # table rows per plain-version chunk (the TPU kernel's sublane step)

_INF = 3.0e38

# Launches of each kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# versions are not counted.
LAUNCHES = {"brute_closest": 0, "brute_any": 0}

SOURCES = ["brute_trace.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``brute_trace.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.brute_closest.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.brute_closest.restype = ctypes.c_int
    lib.brute_any.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, ptr]
    lib.brute_any.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernels (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("brute_trace", SOURCES))
    return _lib


def kernel_resources() -> dict:
    """The constants the library was compiled with: rays a thread, table
    rows a shared-memory chunk, static shared memory a block (bytes)."""
    lib = kernel_library()
    return {"rays_per_thread": lib.brute_rays_per_thread(), "chunk_rows": lib.brute_chunk_rows(),
            "shared_bytes_per_block": lib.brute_shared_bytes()}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def moller_trumbore(col, o, d):
    """No-cull Moller-Trumbore in the operation order of the CUDA kernels
    (csrc ``mt_row``) and of pallas_trace.py::_mt_chunk.  ``col(j)`` is
    column j of the triangle rows (v0 0-2, e1 3-5, e2 6-8 of the packed
    table); ``o`` and ``d`` are the ray origin's and direction's (x, y, z)
    components; all broadcast together.  Returns (hit without a t bound,
    t, u, v)."""
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (det.abs() >= 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, t, u, v


def _mt_chunk(tri: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_cur: torch.Tensor):
    """Moller-Trumbore of an (8, 16) chunk against N rays.  Returns (hit,
    t, u, v), each (N, 8); ``hit`` includes ``t < t_cur``."""
    hit, t, u, v = moller_trumbore(lambda j: tri[:, j][None, :], (o[:, 0:1], o[:, 1:2], o[:, 2:3]),
                                   (d[:, 0:1], d[:, 1:2], d[:, 2:3]))
    return hit & (t < t_cur[:, None]), t, u, v


def trace_closest_plain(tri_tab, origin, direction, t_max):
    """Closest hit; returns (t, tri_id int32, u, v), each (N,)."""
    n = origin.shape[0]
    t = t_max.clone()
    pid = torch.full((n,), -1.0, dtype=torch.float32, device=origin.device)
    uu = torch.zeros(n, dtype=torch.float32, device=origin.device)
    vv = torch.zeros_like(uu)
    for base in range(0, tri_tab.shape[0], TRI_SUB):
        tri = tri_tab[base:base + TRI_SUB]
        hit, tc, uc, vc = _mt_chunk(tri, origin, direction, t)
        tc_m = torch.where(hit, tc, _INF)
        t_best, best = tc_m.min(dim=1, keepdim=True)  # first index among equal minima
        any_hit = hit.gather(1, best)[:, 0]
        upd = any_hit & (t_best[:, 0] < t)
        t = torch.where(upd, t_best[:, 0], t)
        pid = torch.where(upd, tri[:, 9][best[:, 0]], pid)
        uu = torch.where(upd, uc.gather(1, best)[:, 0], uu)
        vv = torch.where(upd, vc.gather(1, best)[:, 0], vv)
    return t, pid.to(torch.int32), uu, vv


def trace_any_plain(tri_tab, origin, direction, t_max):
    """Occlusion: True where some triangle is hit with 0 < t < t_max."""
    occ = torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device)
    for base in range(0, tri_tab.shape[0], TRI_SUB):
        hit, _, _, _ = _mt_chunk(tri_tab[base:base + TRI_SUB], origin, direction, t_max)
        occ |= hit.any(dim=1)  # in place: one (N,) mask for the whole loop
    return occ


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_inputs(tri_tab, origin, direction, t_max) -> int:
    n = origin.shape[0] if origin.dim() == 2 else -1
    checks = (
        (tri_tab.dim() == 2 and tri_tab.shape[1] == 16 and tri_tab.shape[0] % TRI_SUB == 0,
         f"tri_tab must be (Tpad, 16) with Tpad % {TRI_SUB} == 0, got {tuple(tri_tab.shape)}"),
        (origin.dim() == 2 and origin.shape[1] == 3, f"origin must be (N, 3), got {tuple(origin.shape)}"),
        (tuple(direction.shape) == (n, 3), f"direction must be ({n}, 3), got {tuple(direction.shape)}"),
        (tuple(t_max.shape) == (n,), f"t_max must be ({n},), got {tuple(t_max.shape)}"),
        (n < 2**31, "more than 2^31 - 1 rays"),
        (tri_tab.data_ptr() % 16 == 0, "tri_tab must be 16-byte aligned (the kernels copy its rows as float4)"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    for name, a in (("tri_tab", tri_tab), ("origin", origin), ("direction", direction), ("t_max", t_max)):
        if a.device.type != "cuda" or a.device != origin.device:
            raise ValueError(f"{name} must be on the rays' CUDA device, got {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")
    return n


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def trace_closest_cuda(tri_tab, origin, direction, t_max, coherent: bool = False):
    """Kernel B1: closest hit on the card; same outputs as trace_closest_plain.
    ``coherent`` says that consecutive rays are neighbours (primary rays): the
    kernel then lets a warp skip the rest of a test that none of its rays can
    pass, which changes no result and pays only for such rays."""
    n = _check_inputs(tri_tab, origin, direction, t_max)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    tri_id = torch.empty(n, dtype=torch.int32, device=origin.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return t, tri_id, u, v
    lib = kernel_library()
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.brute_closest(
            tri_tab.data_ptr(), tri_tab.shape[0], origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), n, t.data_ptr(), tri_id.data_ptr(), u.data_ptr(), v.data_ptr(), int(coherent), stream,
        )
    _raise_on(err, "brute_closest")
    count_launch(LAUNCHES, "brute_closest", "closest_kernel")
    return t, tri_id, u, v


def trace_any_cuda(tri_tab, origin, direction, t_max):
    """Kernel B2: occlusion on the card; same output as trace_any_plain."""
    n = _check_inputs(tri_tab, origin, direction, t_max)
    occ = torch.empty(n, dtype=torch.bool, device=origin.device)  # one byte per ray
    if n == 0:
        return occ
    lib = kernel_library()
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.brute_any(
            tri_tab.data_ptr(), tri_tab.shape[0], origin.data_ptr(), direction.data_ptr(),
            t_max.data_ptr(), n, occ.data_ptr(), stream,
        )
    _raise_on(err, "brute_any")
    count_launch(LAUNCHES, "brute_any", "any_kernel")
    return occ
