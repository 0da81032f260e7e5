"""LTC polygon kernel B6: per ray, the radiance summed over all triangle lights.

Counterpart of ``optix_renderer_tpu/shading/ltc_pallas.py``.  Two pieces:

* the wrapper ``ltc_integrate_cuda``, which checks its inputs, allocates
  the (R, 3) output and launches the hand-written CUDA kernel in
  ``csrc/ltc.cu`` on the current stream, counting each launch in
  ``LAUNCHES``;
* the plain PyTorch version ``ltc_integrate_plain``: the flat (L*R,)
  pipeline of the JAX package's XLA branch (``ltc.py:202-265``) in its
  order of operations -- translate, the back-face test, the fused diffuse
  frame, the triangle clip, the edge integrals, then the LTC frame and the
  second clip of the ORIGINAL triangle with the first clip's vertex count
  (the reference's own sequence, ltc_utils.cuh:94-101).  Its sum over the
  lights runs in light order, as the kernel's does.

Both keep the reference's LTC brightness (no 1/pi, no 0.5 lobe weights).
Operands: p, diffuse (R, 3); mat_a = iso @ to_local and
mat_b = ltc_inv @ mat_a, row-major (R, 9); amplitude (R,); lights
(L, 16) rows ``[v1 v2 v3 normal emit pad]`` (``pack_lights``).
"""

from __future__ import annotations

import ctypes

import torch

from .ltc import _masked_polygon_integral_c, _norm3c
from .polygon_clip import clip_polygon_c

# light row layout of the (L, 16) operand
_L_V1, _L_V2, _L_V3, _L_N, _L_EMIT = 0, 3, 6, 9, 12

# Launches of the kernel since the last reset_launch_counts(); the plain
# version is not counted.
LAUNCHES = {"ltc": 0}

SOURCES = ["ltc.cu"]  # under csrc/
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        lib = load_library("ltc", SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ltc_integrate.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr, i32, ptr, ptr]
        lib.ltc_integrate.restype = ctypes.c_int
        _lib = lib
    return _lib


def pack_lights(light_v1, light_v2, light_v3, light_normal, light_emit) -> torch.Tensor:
    """(L, 16) kernel operand from the DeviceScene light arrays."""
    pad = light_v1.new_zeros((light_v1.shape[0], 1))
    return torch.cat([light_v1, light_v2, light_v3, light_normal, light_emit, pad], dim=1).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def ltc_integrate_plain(p, diffuse, mat_a, mat_b, amplitude, lights) -> torch.Tensor:
    """Summed LTC radiance over all lights, (R, 3); zeros when L == 0."""
    R = p.shape[0]
    L = lights.shape[0]
    out = torch.zeros((R, 3), dtype=torch.float32, device=p.device)
    if L == 0 or R == 0:
        return out

    def per_ray(v):  # (R,) -> (L*R,), light-major
        return v.repeat(L)

    def per_light(v):  # (L,) -> (L*R,), light-major
        return v.repeat_interleave(R)

    px, py, pz = (per_ray(p[:, a]) for a in range(3))

    def translate(col):  # light corner at lights[:, col:col+3] -> normalized (L*R,) comps
        return _norm3c(per_light(lights[:, col]) - px,
                       per_light(lights[:, col + 1]) - py,
                       per_light(lights[:, col + 2]) - pz)

    l1, l2, l3 = translate(_L_V1), translate(_L_V2), translate(_L_V3)
    cgx, cgy, cgz = _norm3c(l1[0] + l2[0] + l3[0], l1[1] + l2[1] + l3[1], l1[2] + l2[2] + l3[2])
    lnx, lny, lnz = (per_light(lights[:, _L_N + a]) for a in range(3))
    facing = -(cgx * lnx + cgy * lny + cgz * lnz) >= 0.0  # back-face test, ltc_utils.cuh:62-64

    def xform(m, v):  # m: (R, 9) row-major per-ray matrix, v: (L*R,) comps
        x, y, z = v
        mr = lambda k: per_ray(m[:, k])  # noqa: E731
        return _norm3c(mr(0) * x + mr(1) * y + mr(2) * z,
                       mr(3) * x + mr(4) * y + mr(5) * z,
                       mr(6) * x + mr(7) * y + mr(8) * z)

    def slots(a, b, c):
        return [a, b, c, a, a]

    # first clip: the cosine (diffuse) polygon, slots [v1 v2 v3 v1 v1]
    a1, a2, a3 = xform(mat_a, l1), xform(mat_a, l2), xform(mat_a, l3)
    vc0 = torch.full_like(px, 3, dtype=torch.int32)
    dx, dy, dz, dvc = clip_polygon_c(slots(a1[0], a2[0], a3[0]), slots(a1[1], a2[1], a3[1]),
                                     slots(a1[2], a2[2], a3[2]), vc0, tri_input=True)
    diffuse_shading = _masked_polygon_integral_c(dx, dy, dz, dvc)

    # second clip: the LTC-transformed ORIGINAL triangle with the first
    # clip's vertex count (ltc_utils.cuh:94-101)
    t1, t2, t3 = xform(mat_b, l1), xform(mat_b, l2), xform(mat_b, l3)
    gx, gy, gz, gvc = clip_polygon_c(slots(t1[0], t2[0], t3[0]), slots(t1[1], t2[1], t3[1]),
                                     slots(t1[2], t2[2], t3[2]), dvc, tri_input=True)
    ggx_shading = _masked_polygon_integral_c(gx, gy, gz, gvc)

    d = torch.where(facing, diffuse_shading, 0.0).reshape(L, R)
    g = torch.where(facing, ggx_shading, 0.0).reshape(L, R)
    for ch in range(3):
        for light in range(L):  # in light order, as the kernel accumulates
            term = (diffuse[:, ch] * d[light] + amplitude * g[light]) * lights[light, _L_EMIT + ch]
            out[:, ch] = out[:, ch] + term
    return out


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

def _check_inputs(p, diffuse, mat_a, mat_b, amplitude, lights) -> tuple[int, int]:
    r = p.shape[0] if p.dim() == 2 else -1
    checks = (
        (p.dim() == 2 and p.shape[1] == 3, f"p must be (R, 3), got {tuple(p.shape)}"),
        (tuple(diffuse.shape) == (r, 3), f"diffuse must be ({r}, 3), got {tuple(diffuse.shape)}"),
        (tuple(mat_a.shape) == (r, 9), f"mat_a must be ({r}, 9), got {tuple(mat_a.shape)}"),
        (tuple(mat_b.shape) == (r, 9), f"mat_b must be ({r}, 9), got {tuple(mat_b.shape)}"),
        (tuple(amplitude.shape) == (r,), f"amplitude must be ({r},), got {tuple(amplitude.shape)}"),
        (lights.dim() == 2 and lights.shape[1] == 16, f"lights must be (L, 16), got {tuple(lights.shape)}"),
        (r < 2**31 and lights.shape[0] < 2**31, "more than 2^31 - 1 rays or lights"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    for name, a in (("p", p), ("diffuse", diffuse), ("mat_a", mat_a), ("mat_b", mat_b),
                    ("amplitude", amplitude), ("lights", lights)):
        if a.device.type != "cuda" or a.device != p.device:
            raise ValueError(f"{name} must be on the rays' CUDA device, got {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")
    return r, lights.shape[0]


def ltc_integrate_cuda(p, diffuse, mat_a, mat_b, amplitude, lights) -> torch.Tensor:
    """Kernel B6 on the card; same output as ltc_integrate_plain."""
    r, n_lights = _check_inputs(p, diffuse, mat_a, mat_b, amplitude, lights)
    if r == 0 or n_lights == 0:  # nothing to sum; a grid of 0 blocks is an invalid launch
        return torch.zeros((r, 3), dtype=torch.float32, device=p.device)
    out = torch.empty((r, 3), dtype=torch.float32, device=p.device)
    lib = kernel_library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ltc_integrate(p.data_ptr(), diffuse.data_ptr(), mat_a.data_ptr(), mat_b.data_ptr(),
                                amplitude.data_ptr(), r, lights.data_ptr(), n_lights, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ltc_integrate launch failed: cudaError {err}")
    LAUNCHES["ltc"] += 1
    return out
