"""The brute tier's shade gather as a hand-written CUDA kernel, K3.

Counterpart of what XLA fuses of ``optix_renderer_tpu/engine/shade.py:
33-69,100-139`` (``_shade_onehot`` and ``_finalize``): the JAX package has
no Pallas kernel there, so this replaces XLA's fusion, not a TPU kernel.
Per lane, from the brute tier's Hit (tri_id, u, v), the kernel of
``csrc/brute_shade.cu`` gathers the triangle's packed row
(``scene.device.tri_pack``, 35 floats, at most 4,096 rows; the kernel reads
``padded_pack``'s copy, 36 floats a row, as nine 16-byte words), interpolates
p, the shading normal and uv, wraps uv with ``abs(fmod(uv, 1))``, takes
the bilinear atlas sample where the scene has textures, clamps alpha and
writes the miss program's fill: the ``SurfaceInteraction`` of
``engine.shade.build_surface_interaction``, its plain version, field for
field in the same dtypes and (N, 3) row-major layout.

``engine.shade.trace_closest_si`` picks it on the brute tier for a CUDA
tensor; ``brute_shade_cuda`` raises on anything else.  It builds with
``--fmad=false`` and repeats the plain version's operations in their order,
so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ..core.types import Hit, SurfaceInteraction
from ..scene.device import ONEHOT_MAX_TRIS, PACK_K, DeviceScene
from ..utils.launches import count_launch

# Launches of the kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# version is not counted.
LAUNCHES = {"brute_shade": 0}

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

SOURCES = ["brute_shade.cu"]  # under csrc/
_lib = None
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


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("brute_shade", SOURCES))
    return _lib


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


def brute_shade_cuda(ds: DeviceScene, hit: Hit) -> SurfaceInteraction:
    """K3 on the card; the same SurfaceInteraction as
    ``engine.shade.build_surface_interaction``."""
    if ds.num_tris > ONEHOT_MAX_TRIS:
        raise ValueError(f"the brute tier's shading reads packed rows for at most {ONEHOT_MAX_TRIS} triangles")
    n = hit.tri_id.shape[0]
    dev = hit.tri_id.device
    if dev.type != "cuda":
        raise ValueError(f"brute_shade takes CUDA tensors, got {dev}")
    atlas = ds.textures
    named = (("tri_id", hit.tri_id, (n,), torch.int32), ("bary_u", hit.bary_u, (n,), torch.float32),
             ("bary_v", hit.bary_v, (n,), torch.float32),
             ("tri_pack", ds.tri_pack, (ds.tri_pack.shape[0], PACK_K), torch.float32),
             ("atlas pixels", atlas.pixels, (atlas.pixels.shape[0], 4), torch.float32),
             ("atlas offset", atlas.offset, (atlas.offset.shape[0],), torch.int32),
             ("atlas width", atlas.width, (atlas.offset.shape[0],), torch.int32),
             ("atlas height", atlas.height, (atlas.offset.shape[0],), torch.int32),
             ("miss_color", ds.miss_color, (3,), torch.float32))
    for name, a, shape, dtype in named:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")

    def empty(*shape, dtype=torch.float32):
        return torch.empty((n, *shape), dtype=dtype, device=dev)

    si = SurfaceInteraction(hit=empty(dtype=torch.bool), p=empty(3), uv=empty(2), n_geom=empty(3),
                            diffuse=empty(3), alpha=empty(), emit=empty(3), is_light=empty(dtype=torch.bool),
                            material_id=empty(dtype=torch.int32), area=empty())
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return si
    lib = kernel_library()
    pack = padded_pack(ds.tri_pack)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.brute_shade(
            n, hit.tri_id.data_ptr(), hit.bary_u.data_ptr(), hit.bary_v.data_ptr(), pack.data_ptr(),
            int(ds.has_textures), atlas.pixels.data_ptr(), atlas.offset.data_ptr(),
            atlas.width.data_ptr(), atlas.height.data_ptr(), ds.miss_color.data_ptr(),
            si.hit.data_ptr(), si.p.data_ptr(), si.uv.data_ptr(), si.n_geom.data_ptr(), si.diffuse.data_ptr(),
            si.alpha.data_ptr(), si.emit.data_ptr(), si.is_light.data_ptr(), si.material_id.data_ptr(),
            si.area.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"brute_shade launch failed: cudaError {err}")
    count_launch(LAUNCHES, "brute_shade", "brute_shade_kernel")
    return si
