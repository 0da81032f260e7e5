"""Pinhole camera: basis construction and primary ray generation
(counterpart of ``optix_renderer_tpu/engine/camera.py``; reference
include/viewer.hpp:634-641 and cuda_src/deviceCode.cu:68-73).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as cm
from ..core.types import Camera, Ray


def camera_from_lookat(from_, at, up, cos_fovy: float, width: int, height: int, device) -> Camera:
    """viewer.hpp:634-641: d00 = normalize(at-from); du = cosFovy*aspect*
    normalize(cross(d00, up)); dv = cosFovy*normalize(cross(du, d00));
    d00 -= (du + dv)/2.  Host numpy arithmetic, identical to the JAX package."""
    from_ = np.asarray(from_, np.float32)
    at = np.asarray(at, np.float32)
    up = np.asarray(up, np.float32)
    d00 = at - from_
    d00 = d00 / np.linalg.norm(d00)
    aspect = width / float(height)
    du = np.cross(d00, up)
    du = cos_fovy * aspect * du / np.linalg.norm(du)
    dv = np.cross(du, d00)
    dv = cos_fovy * dv / np.linalg.norm(dv)
    d00 = d00 - 0.5 * du - 0.5 * dv

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(pos=f32(from_), dir_00=f32(d00), dir_du=f32(du), dir_dv=f32(dv))


def primary_rays(camera: Camera, width: int, height: int, jitter_u, jitter_v, lin=None) -> Ray:
    """Jittered primary rays (deviceCode.cu:68-73).

    jitter_u/jitter_v: (N,) uniforms in [0,1).  Pixel (x, y) is lane
    ``x + y * width``; row 0 is the v=0 edge (bottom).  ``lin`` (absolute
    linear pixel ids) defaults to the full frame.
    """
    if lin is None:
        lin = torch.arange(width * height, dtype=torch.int64, device=camera.pos.device)
    lin = lin.to(torch.int64)
    px = (lin % width).to(torch.float32)
    py = (lin // width).to(torch.float32)
    u = (px + jitter_u) / float(width)
    v = (py + jitter_v) / float(height)
    d = camera.dir_00[None, :] + u[:, None] * camera.dir_du[None, :] + v[:, None] * camera.dir_dv[None, :]
    d = d / cm.sqrt_rn(cm.dot(d, d))[:, None]
    # expand() is a stride-0 view; the trace kernels need real rows
    o = camera.pos[None, :].expand(lin.shape[0], 3).contiguous()
    return Ray(origin=o, direction=d)
