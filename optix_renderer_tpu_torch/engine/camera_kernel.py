"""A frame's camera and RNG head as one hand-written CUDA kernel, K0.

Counterpart of what XLA fuses of ``optix_renderer_tpu/engine/renderer.py:
89-96``: the JAX package has no Pallas kernel there, so this replaces XLA's
fusion, not a TPU kernel.  For each lane of a tile of ``rows`` image rows
from ``row_offset``, in the block-major order of ``pixel_order``, it makes
the absolute pixel id, seeds the RNG state from it and the frame id
(``core.rng.make_rng(frame_id + 10007, pixel)``), draws the two jitters and
makes the jittered primary ray (``engine.camera.primary_rays``).  It
returns the same (Ray, state) as ``camera_rng_plain``, the plain version:
origin and direction (N, 3) float32, the state (N,) int64 in [0, 2^32).

``camera_rng`` picks the kernel for a camera on a CUDA device and the plain
version on the CPU or when the caller asks (``plain=True``).  The frame id
is an int, or a 0-d int64 tensor on the camera's device, which the kernel
reads from device memory: a captured frame graph replays it with the id
its buffers hold.  The kernel builds with ``--fmad=false`` and repeats the
plain version's float operations in their order, so on the card the two
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import rng as rnglib
from ..core.types import Camera, Ray
from ..utils.launches import count_launch
from . import camera as cameralib

# Launches of the kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# version is not counted.
LAUNCHES = {"camera_rng": 0}

# bytes a lane for the kernel's bound: the origin (12), the direction (12)
# and the state (8) written once; it reads nothing a lane
BYTES_LANE = 12 + 12 + 8

SOURCES = ["camera_rng.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_dim(x: int) -> int:
    """Largest pixel-block edge (<= 32) dividing x."""
    for b in (32, 16, 8, 4, 2):
        if x % b == 0:
            return b
    return 1


def pixel_order(width: int, height: int, device, row_offset: int = 0, rows: int | None = None) -> torch.Tensor:
    """Linear pixel ids (int64) of the image rows [row_offset, row_offset +
    rows) (default: the whole frame) in the order primary rays are traced:
    square blocks of up to 32 x 32 over the tile, row-major inside a block."""
    rows = height if rows is None else rows
    bh, bw = block_dim(rows), block_dim(width)
    lin = torch.arange(rows * width, dtype=torch.int64, device=device) + row_offset * width
    return lin.reshape(rows // bh, bh, width // bw, bw).transpose(1, 2).reshape(-1)


def camera_rng_plain(camera: Camera, frame_id, width: int, height: int, row_offset: int = 0,
                     rows: int | None = None) -> tuple[Ray, torch.Tensor]:
    """The tile's primary rays and RNG states in PyTorch (JAX renderer.py:
    89-96): pixel ids in block-major order, ``get_rng(frame_id + 10007,
    pixel)`` (deviceCode.cu:65-66), two jitter draws, the jittered rays."""
    lin = pixel_order(width, height, camera.pos.device, row_offset, rows)
    rstate = rnglib.make_rng(frame_id + 10007, lin)
    rstate, ju = rnglib.lcg_randomf(rstate)
    rstate, jv = rnglib.lcg_randomf(rstate)
    return cameralib.primary_rays(camera, width, height, ju, jv, lin=lin), rstate


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``camera_rng.cu``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # n, width, height, rows, row_offset, bh, bw; the frame id's pointer and value; the camera (4);
    # origin, direction, state; stream
    lib.camera_rng.argtypes = [i32] * 7 + [ptr, i64] + [ptr] * 4 + [ptr] * 3 + [ptr]
    lib.camera_rng.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("camera_rng", SOURCES))
    return _lib


def camera_rng_cuda(camera: Camera, frame_id, width: int, height: int, row_offset: int = 0,
                    rows: int | None = None) -> tuple[Ray, torch.Tensor]:
    """K0 on the card; the same (Ray, state) as camera_rng_plain."""
    rows = height if rows is None else rows
    dev = camera.pos.device
    if dev.type != "cuda":
        raise ValueError(f"camera_rng_cuda takes a camera on a CUDA device, got {dev}")
    if not (0 <= row_offset and 0 < rows and row_offset + rows <= height and 0 < width and rows * width < 2**31):
        raise ValueError(f"rows [{row_offset}, {row_offset + rows}) of a {width} x {height} frame")
    vecs = (camera.pos, camera.dir_00, camera.dir_du, camera.dir_dv)
    for name, a in zip(("pos", "dir_00", "dir_du", "dir_dv"), vecs):
        if a.shape != (3,) or a.dtype != torch.float32 or a.device != dev or not a.is_contiguous():
            raise ValueError(f"camera.{name} must be a contiguous float32 (3,) tensor on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if isinstance(frame_id, torch.Tensor):
        if frame_id.shape != () or frame_id.dtype != torch.int64 or frame_id.device != dev:
            raise ValueError(f"a tensor frame id must be 0-d int64 on {dev}, "
                             f"got {frame_id.dtype} {tuple(frame_id.shape)} on {frame_id.device}")
        id_ptr, id_value = frame_id.data_ptr(), 0
    else:
        id_ptr, id_value = None, int(frame_id) & 0xFFFFFFFF  # the seed keeps 32 bits of frame_id + 10007
    n = rows * width
    origin = torch.empty((n, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((n, 3), dtype=torch.float32, device=dev)
    state = torch.empty((n,), dtype=torch.int64, device=dev)
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.camera_rng(n, width, height, rows, row_offset, block_dim(rows), block_dim(width), id_ptr, id_value,
                             *(a.data_ptr() for a in vecs), origin.data_ptr(), direction.data_ptr(),
                             state.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"camera_rng launch failed: cudaError {err}")
    count_launch(LAUNCHES, "camera_rng", "camera_rng_kernel")
    return Ray(origin=origin, direction=direction), state


def camera_rng(camera: Camera, frame_id, width: int, height: int, row_offset: int = 0, rows: int | None = None,
               plain: bool = False) -> tuple[Ray, torch.Tensor]:
    """The tile's primary rays and RNG states: K0 for a camera on a CUDA
    device (its plain version only when the caller asks, ``plain=True``),
    the plain version on the CPU; any other device raises."""
    dev = camera.pos.device
    if dev.type == "cuda" and not plain:
        return camera_rng_cuda(camera, frame_id, width, height, row_offset, rows)
    if dev.type in ("cuda", "cpu"):
        return camera_rng_plain(camera, frame_id, width, height, row_offset, rows)
    raise ValueError(f"no camera and RNG head for device {dev}")
