"""The cluster tier's per-ray supercluster sweep as one hand-written CUDA
kernel, K-sweep.

Counterpart of what XLA fuses of ``optix_renderer_tpu/accel/pallas_cluster.py:
151-256``: the JAX package has no Pallas kernel there, so this replaces XLA's
fusion, not a TPU kernel.  For each ray it slab-tests every box of the sweep
(the superclusters, or the cluster boxes themselves where there are at most
512) and returns the ray's t bound, ``accel.cluster.ray_t_bounds``, and where
asked its corridor sort key, ``accel.cluster.corridor_keys_and_t_bounds``:
the same bits as those functions' plain PyTorch sweep run on the card.

``accel.cluster`` calls ``sc_sweep_cuda`` for rays on a CUDA device, inside
the ``trace.sweep`` span; rays on the CPU take the plain sweep.  The kernel
builds with ``--fmad=false`` and repeats the plain version's float
operations in their order.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.launches import count_launch

# Launches of the kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# sweep is not counted.
LAUNCHES = {"sc_sweep": 0}

# bytes a lane for the kernel's bound: the origin and direction (24) and
# t_max (4) read, the t bound (4) and the key (4) written; the boxes are
# read once a block from the cache
BYTES_LANE = 24 + 4 + 4 + 4

SOURCES = ["sc_sweep.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``sc_sweep.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # n, s, key bits; box min and max; origin, direction; t_max's pointer, stride and value; t, key; stream
    lib.sc_sweep.argtypes = [i32] * 3 + [ptr] * 2 + [ptr] * 2 + [ptr, i32, ctypes.c_float] + [ptr] * 2 + [ptr]
    lib.sc_sweep.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("sc_sweep", SOURCES))
    return _lib


def sc_sweep_cuda(box_min: torch.Tensor, box_max: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                  t_max, key_bits: int | None = None):
    """K-sweep on the card: (t bound (N,) float32, key (N,) int32 or None).

    ``box_min``/``box_max`` (S, 3) and ``origin``/``direction`` (N, 3):
    contiguous float32 on one CUDA device.  ``t_max``: a number, or a
    float32 tensor of shape (), (1,) or (N,) on that device.  ``key_bits``:
    None for the t bound alone, else the key's bits an index,
    ``cluster._cid_bits(S)``.  Anything else raises before the library is
    built or loaded."""
    n, s = (origin.shape[0] if origin.dim() else 0), (box_min.shape[0] if box_min.dim() else 0)
    tensors = {"origin": origin, "direction": direction, "box_min": box_min, "box_max": box_max}
    for name, a in tensors.items():
        rows = n if name in ("origin", "direction") else s
        if a.shape != (rows, 3) or a.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 ({rows}, 3) tensor, got {a.dtype} {tuple(a.shape)}")
    if not (0 < s < 2**31 and n < 2**31):
        raise ValueError(f"a sweep of {n} rays over {s} boxes")
    if key_bits is not None and not (1 <= key_bits <= 31 and s <= 1 << key_bits):
        raise ValueError(f"{key_bits} key bits an index cannot hold {s} boxes")
    if isinstance(t_max, torch.Tensor):
        if t_max.shape not in ((), (1,), (n,)) or t_max.dtype != torch.float32:
            raise ValueError(f"a tensor t_max must be float32 of shape (), (1,) or ({n},), "
                             f"got {t_max.dtype} {tuple(t_max.shape)}")
        tensors["t_max"] = t_max
        t_ptr, t_stride, t_value = t_max.data_ptr(), int(t_max.numel() == n and n > 1), 0.0
    else:
        t_ptr, t_stride, t_value = None, 0, float(t_max)
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"sc_sweep_cuda takes rays on a CUDA device, got {dev}")
    for name, a in tensors.items():
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}, got a tensor on {a.device} with strides "
                             f"{a.stride()}")
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    key = None if key_bits is None else torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, key
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sc_sweep(n, s, -1 if key_bits is None else key_bits, box_min.data_ptr(), box_max.data_ptr(),
                           origin.data_ptr(), direction.data_ptr(), t_ptr, t_stride, t_value, t_out.data_ptr(),
                           None if key is None else key.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sc_sweep launch failed: cudaError {err}")
    count_launch(LAUNCHES, "sc_sweep", "supercluster_sweep_kernel")
    return t_out, key
