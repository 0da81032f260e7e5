"""The shading kernels: K3, the brute tier's shade gather, and K4, the
cluster tier's winners to the SurfaceInteraction, each a hand-written CUDA
kernel.

K3 is the counterpart of what XLA fuses of ``optix_renderer_tpu/engine/
shade.py:33-69,100-139`` (``_shade_onehot`` and ``_finalize``): the JAX
package has no Pallas kernel there, so this replaces XLA's fusion, not a TPU
kernel.  Per lane, from the brute tier's Hit (tri_id, u, v), the kernel of
``csrc/brute_shade.cu`` gathers the triangle's packed row
(``scene.device.tri_pack``, 35 floats, at most 4,096 rows; the kernel reads
``padded_pack``'s copy, 36 floats a row, as nine 16-byte words), interpolates
p, the shading normal and uv, wraps uv with ``abs(fmod(uv, 1))``, takes
the bilinear atlas sample where the scene has textures, clamps alpha and
writes the miss program's fill: the ``SurfaceInteraction`` of
``engine.shade.build_surface_interaction``, its plain version, field for
field in the same dtypes and (N, 3) row-major layout.

K4 (``csrc/cluster_shade.cu``) does the same from the cluster tier's packed
winners (key, cid) and the rays: it reads the winning triangle's rows of
``bvh.shade_a`` and ``bvh.shade_b`` (the fetch of kernel B5, which stood for
``optix_renderer_tpu/accel/pallas_cluster.py:1657``), repeats
Moller-Trumbore for exact (t, u, v) and shades as XLA fuses
``optix_renderer_tpu/engine/shade.py:141-275``.  Its plain version is
``engine.shade.shade_winners_plain``: ``accel.cluster_trace.
fetch_winner_attrs_plain`` followed by ``build_surface_interaction_fused``.

``engine.shade.trace_closest_si`` picks K3 on the brute tier and K4 on the
cluster tier for a CUDA tensor; the wrappers raise on anything else.  Both
build with ``--fmad=false`` and repeat their plain versions' operations in
their order, so on the card each agrees with its plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ..accel.build import SHADE_A_COLS, SHADE_B_COLS
from ..core.types import Hit, Ray, SurfaceInteraction
from ..scene.device import ONEHOT_MAX_TRIS, PACK_K, DeviceScene
from ..utils.launches import count_launch

# Launches of the kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# version is not counted.
LAUNCHES = {"brute_shade": 0, "cluster_shade": 0}

# f32 operations of a hit lane (adds, subtracts, multiplies, divisions,
# square roots, clamps, fmods, conversions) as csrc/brute_shade.cu writes
# them, for the kernel's bound: w 2, p 15, the normal 25, uv 12, alpha 2,
# the material id 1; a textured lane's bilinear sample 42 more.  A miss
# lane writes its fill and computes nothing.
OPS_SHADE, OPS_TEXTURE = 57, 42
# bytes, each input read once and each output written once, for the bound:
# tri_id, u, v (12) and the SurfaceInteraction (70) a lane, and each
# distinct row of tri_pack it reads (140)
BYTES_SHADE, BYTES_ROW = 12 + 70, PACK_K * 4
# K4's bytes for its bound: key and cid (8), the ray (24) and the
# SurfaceInteraction (70) a lane, and each winning row of shade_a and
# shade_b it reads (112)
BYTES_WINNER, BYTES_WINNER_ROW = 8 + 24 + 70, (SHADE_A_COLS + SHADE_B_COLS) * 4

SOURCES = ["brute_shade.cu"]  # under csrc/ (and shade_common.cuh, which it includes)
CLUSTER_SOURCES = ["cluster_shade.cu"]  # K4's
_lib = None
_cluster_lib = None
PADDED_K = 36  # the kernel's row: PACK_K floats and one of zeros, 144 bytes
# id(tri_pack) -> (its version, the padded copy), an entry for as long as its
# tri_pack lives: a frame graph replays K3 on the copy it captured, so a
# copy must outlive every graph of its scene, whatever other scenes shade
_padded_packs: dict[int, tuple[int, torch.Tensor]] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``brute_shade.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # n; tri_id, u, v; tri_pack; has_textures and the atlas (4); miss color; the 10 fields; stream
    lib.brute_shade.argtypes = [i32] + [ptr] * 3 + [ptr] + [i32] + [ptr] * 4 + [ptr] + [ptr] * 10 + [ptr]
    lib.brute_shade.restype = ctypes.c_int
    return lib


def bind_cluster_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``cluster_shade.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # n; key, cid; origin, direction; shade_a, shade_b; the mesh's six arrays; has_textures and the atlas (4);
    # miss color; the 10 fields; stream
    lib.cluster_shade.argtypes = ([i32] + [ptr] * 2 + [ptr] * 2 + [ptr] * 2 + [ptr] * 6 + [i32] + [ptr] * 4 + [ptr]
                                  + [ptr] * 10 + [ptr])
    lib.cluster_shade.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled K3 (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("brute_shade", SOURCES))
    return _lib


def cluster_kernel_library() -> ctypes.CDLL:
    """The compiled K4 (built from csrc/ at first use)."""
    global _cluster_lib
    if _cluster_lib is None:
        from ..utils.cuda_build import load_library

        _cluster_lib = bind_cluster_library(load_library("cluster_shade", CLUSTER_SOURCES))
    return _cluster_lib


def padded_pack(tri_pack: torch.Tensor) -> torch.Tensor:
    """``tri_pack`` (T, PACK_K) padded with zeros to (T, PADDED_K), so that
    each row starts on a 16-byte boundary; made once a tensor: the same
    tensor, unchanged since, gets the same copy back for as long as it
    lives.  A copy is made eagerly: inside a CUDA graph's capture it would
    hold nothing until the first replay, so a capture must find it made."""
    key = id(tri_pack)
    entry = _padded_packs.get(key)
    if entry is not None and entry[0] == tri_pack._version:
        return entry[1]
    if tri_pack.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("padded_pack: the scene's table is padded outside a CUDA graph's capture "
                           "(its eager frame comes first)")
    if entry is None:
        weakref.finalize(tri_pack, _padded_packs.pop, key, None)
    padded = torch.zeros((tri_pack.shape[0], PADDED_K), dtype=tri_pack.dtype, device=tri_pack.device)
    padded[:, :PACK_K] = tri_pack
    _padded_packs[key] = (tri_pack._version, padded)
    return padded


def _check_inputs(dev: torch.device, named) -> None:
    """Each (name, tensor, shape, dtype) of ``named`` on ``dev``, contiguous."""
    for name, a, shape, dtype in named:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")


def _atlas_inputs(ds: DeviceScene) -> tuple:
    atlas = ds.textures
    k = atlas.offset.shape[0]
    return (("atlas pixels", atlas.pixels, (atlas.pixels.shape[0], 4), torch.float32),
            ("atlas offset", atlas.offset, (k,), torch.int32), ("atlas width", atlas.width, (k,), torch.int32),
            ("atlas height", atlas.height, (k,), torch.int32), ("miss_color", ds.miss_color, (3,), torch.float32))


def _empty_si(n: int, dev: torch.device) -> SurfaceInteraction:
    def empty(*shape, dtype=torch.float32):
        return torch.empty((n, *shape), dtype=dtype, device=dev)

    return SurfaceInteraction(hit=empty(dtype=torch.bool), p=empty(3), uv=empty(2), n_geom=empty(3),
                              diffuse=empty(3), alpha=empty(), emit=empty(3), is_light=empty(dtype=torch.bool),
                              material_id=empty(dtype=torch.int32), area=empty())


def _si_pointers(si: SurfaceInteraction) -> tuple:
    return (si.hit.data_ptr(), si.p.data_ptr(), si.uv.data_ptr(), si.n_geom.data_ptr(), si.diffuse.data_ptr(),
            si.alpha.data_ptr(), si.emit.data_ptr(), si.is_light.data_ptr(), si.material_id.data_ptr(),
            si.area.data_ptr())


def brute_shade_cuda(ds: DeviceScene, hit: Hit) -> SurfaceInteraction:
    """K3 on the card; the same SurfaceInteraction as
    ``engine.shade.build_surface_interaction``."""
    if ds.num_tris > ONEHOT_MAX_TRIS:
        raise ValueError(f"the brute tier's shading reads packed rows for at most {ONEHOT_MAX_TRIS} triangles")
    n = hit.tri_id.shape[0]
    dev = hit.tri_id.device
    if dev.type != "cuda":
        raise ValueError(f"brute_shade takes CUDA tensors, got {dev}")
    _check_inputs(dev, (("tri_id", hit.tri_id, (n,), torch.int32), ("bary_u", hit.bary_u, (n,), torch.float32),
                        ("bary_v", hit.bary_v, (n,), torch.float32),
                        ("tri_pack", ds.tri_pack, (ds.tri_pack.shape[0], PACK_K), torch.float32),
                        *_atlas_inputs(ds)))
    si = _empty_si(n, dev)
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return si
    lib = kernel_library()
    pack = padded_pack(ds.tri_pack)
    atlas = ds.textures
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.brute_shade(
            n, hit.tri_id.data_ptr(), hit.bary_u.data_ptr(), hit.bary_v.data_ptr(), pack.data_ptr(),
            int(ds.has_textures), atlas.pixels.data_ptr(), atlas.offset.data_ptr(),
            atlas.width.data_ptr(), atlas.height.data_ptr(), ds.miss_color.data_ptr(), *_si_pointers(si), stream)
    if err != 0:
        raise RuntimeError(f"brute_shade launch failed: cudaError {err}")
    count_launch(LAUNCHES, "brute_shade", "brute_shade_kernel")
    return si


def cluster_shade_cuda(ds: DeviceScene, shade_a: torch.Tensor, shade_b: torch.Tensor, rays: Ray,
                       key: torch.Tensor, cid: torch.Tensor) -> SurfaceInteraction:
    """K4 on the card: the SurfaceInteraction of the cluster tier's winners
    (``key``, ``cid``: ``accel.traverse.trace_closest_winners``; cid < 0 a
    miss) for ``rays``, the same as ``engine.shade.shade_winners_plain``."""
    n = key.shape[0] if key.dim() == 1 else -1
    dev = key.device
    tp, m = shade_a.shape[0], ds.mesh_alpha.shape[0]
    _check_inputs(dev, (("key", key, (n,), torch.int32), ("cid", cid, (n,), torch.int32),
                        ("origin", rays.origin, (n, 3), torch.float32),
                        ("direction", rays.direction, (n, 3), torch.float32),
                        ("shade_a", shade_a, (tp, SHADE_A_COLS), torch.float32),
                        ("shade_b", shade_b, (tp, SHADE_B_COLS), torch.float32),
                        ("mesh_diffuse", ds.mesh_diffuse, (m, 3), torch.float32),
                        ("mesh_emit", ds.mesh_emit, (m, 3), torch.float32),
                        ("mesh_alpha", ds.mesh_alpha, (m,), torch.float32),
                        ("mesh_is_light", ds.mesh_is_light, (m,), torch.bool),
                        ("mesh_material_id", ds.mesh_material_id, (m,), torch.int32),
                        ("mesh_diffuse_tex", ds.mesh_diffuse_tex, (m,), torch.int32), *_atlas_inputs(ds)))
    if shade_a.data_ptr() % 16 or shade_b.data_ptr() % 16:
        raise ValueError("shade_a and shade_b must be 16-byte aligned (the kernel reads their rows 16 bytes at a time)")
    if dev.type != "cuda":
        raise ValueError(f"cluster_shade takes CUDA tensors, got {dev}")
    if n >= 2**31:
        raise ValueError(f"cluster_shade takes fewer than 2^31 lanes, got {n}")
    si = _empty_si(n, dev)
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return si
    lib = cluster_kernel_library()
    atlas = ds.textures
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cluster_shade(
            n, key.data_ptr(), cid.data_ptr(), rays.origin.data_ptr(), rays.direction.data_ptr(),
            shade_a.data_ptr(), shade_b.data_ptr(), ds.mesh_diffuse.data_ptr(), ds.mesh_emit.data_ptr(),
            ds.mesh_alpha.data_ptr(), ds.mesh_is_light.data_ptr(), ds.mesh_material_id.data_ptr(),
            ds.mesh_diffuse_tex.data_ptr(), int(ds.has_textures), atlas.pixels.data_ptr(), atlas.offset.data_ptr(),
            atlas.width.data_ptr(), atlas.height.data_ptr(), ds.miss_color.data_ptr(), *_si_pointers(si), stream)
    if err != 0:
        raise RuntimeError(f"cluster_shade launch failed: cudaError {err}")
    count_launch(LAUNCHES, "cluster_shade", "cluster_shade_kernel")
    return si
