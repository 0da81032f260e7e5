"""Multi-bounce path tracer with full MIS (counterpart of
``optix_renderer_tpu/integrators/path.py``; the intended estimator of the
reference's cuda_include/path/path.cuh: next-event estimation + BSDF
sampling combined with the balance heuristic).

The bounce loop is a Python loop over a static depth with an ``alive``
mask: every lane runs the NEE shadow trace and the BSDF bounce trace each
bounce (masked), so shapes stay static; what a bounce computes around its
two traces is ``path_kernel``'s two kernels.  Compaction is a later layer.
Nothing in the loop reads a value back to the host: the per-bounce counts
stay on the device until ``Renderer.metrics`` drains them.
"""

from __future__ import annotations

import torch

from ..accel.traverse import trace_any
from ..core import math as cm
from ..core.types import Ray, SurfaceInteraction
from ..engine.shade import trace_closest_si
from ..scene.device import DeviceScene
from ..shading.bsdf import EPS
from ..utils.launches import span
from . import path_kernel
from .path_kernel import RAY_EPS, PathState, gather_light_attrs, pdf_area_to_solid_angle  # noqa: F401 (re-exported)


def _bounce_fns(dev: torch.device, plain: bool):
    """(K1, K2) for lanes on ``dev``: the CUDA kernels on a CUDA device
    (their plain versions only when the caller asks, ``plain=True``), the
    plain versions on the CPU; any other device raises."""
    if dev.type == "cuda" and not plain:
        return path_kernel.path_sample_cuda, path_kernel.path_combine_cuda
    if dev.type in ("cuda", "cpu"):
        return path_kernel.path_sample_plain, path_kernel.path_combine_plain
    raise ValueError(f"no path bounce for device {dev}")


def path_color(ds: DeviceScene, bvh, rays: Ray, si: SurfaceInteraction, rng_state: torch.Tensor,
               max_depth: int = 10, plain: bool = False):
    """Radiance for each primary ray; returns (color (N, 3), rng_state,
    alive_counts (max_depth, 3) int64 on the device).

    A bounce is kernel K1 (``path_kernel.path_sample_*``: frame, light
    sample, NEE, BSDF sample), the shadow trace, the bounce trace with its
    shading, then K2 (``path_combine_*``: NEE and emission adds, MIS,
    throughput, the next state).  The lanes' device picks them: a CUDA
    tensor launches the kernels (``plain=True``: their plain versions and
    the brute tier's plain shading, for a comparison on the card), a CPU
    tensor runs the plain versions.

    On the cluster tier the shadow and bounce rays are incoherent: both
    traces are corridor-sorted (JAX path.py with its default NEE sort).

    alive_counts columns per bounce: [0] lanes alive, [1] NEE shadow rays
    actually traced (lanes whose contribution is not provably zero), [2]
    bounce closest rays actually traced (valid BSDF samples).

    Outer PATH-mode wrapping (deviceCode.cu:146-153): miss lanes get the
    background, direct light hits raw emission; everything else is the
    path estimate, floored at EPS per channel (path.cuh:254-256).
    """
    n = rays.origin.shape[0]
    dev = rays.origin.device
    path_sample, path_combine = _bounce_fns(dev, plain)

    with span("frame.path_init"):  # the path state before the first bounce
        alive_counts = torch.zeros((max_depth, 3), dtype=torch.int64, device=dev)
        color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        # K2 returns a new state each bounce: the primary hit's fields, which
        # render_tile turns into the g-buffers, are never written
        state = PathState(p=si.p, nrm=si.n_geom, v=cm.normalize(rays.origin - si.p, eps=1e-30),  # toward the camera
                          diffuse=si.diffuse, alpha=si.alpha, tp=torch.ones((n, 3), dtype=torch.float32, device=dev),
                          alive=si.hit & ~si.is_light)
    rng = rng_state

    for d in range(max_depth):
        with span("frame.bounce.sample"):
            b = path_sample(ds, state, rng)
        rng = b.rng
        with span("frame.bounce.shadow"):
            occluded = trace_any(bvh, Ray(origin=b.origin, direction=b.shadow_dir), t_max=b.shadow_t, coherent=False)
        with span("frame.bounce.trace"):
            bounce_si = trace_closest_si(ds, bvh, Ray(origin=b.origin, direction=b.bounce_dir), active=b.sample_ok,
                                         coherent=False, t_max=b.bounce_t, plain=plain)
        with span("frame.bounce.count"):
            alive_counts[d] = torch.stack([state.alive.sum(), b.shadow_needed.sum(), b.sample_ok.sum()])
        with span("frame.bounce.combine"):
            color, state = path_combine(ds.num_lights, color, state, b, occluded, bounce_si)

    # EPS floor on the estimate (path.cuh:254-256), then the outer mode
    # wrapping (deviceCode.cu:146-153)
    with span("frame.finish"):
        estimate = torch.clamp(color, min=EPS)
        out = torch.where(si.is_light[:, None], si.emit, estimate)
        out = torch.where(si.hit[:, None], out, ds.miss_color[None, :])
    return out, rng, alive_counts
