"""The path tracer's bounce as two hand-written CUDA kernels, K1 and K2.

Counterpart of what XLA fuses of the body of ``lax.fori_loop`` in
``optix_renderer_tpu/integrators/path.py:127-245``: the JAX package has no
Pallas kernel there, so these replace XLA's fusions, not a TPU kernel.  A
bounce is K1, then the two traces (B2 on the shadow ray, B1 or the cluster
tier's walks on the bounce ray, with its shading), then K2:

* K1 ``path_sample``: everything of a bounce before its traces -- the
  shading frame, ``wo_local``, the five LCG draws, the light pick and its
  attributes, the light sample, the shadow ray and its solid-angle pdf,
  the BSDF pdf and value at the light direction, ``mis_nee``, the NEE
  contribution before occlusion and ``shadow_needed``; then the BSDF
  sample, ``cos_i``, ``sample_ok``, the BSDF value and the bounce
  direction.  It writes both rays (one origin), their ``t_max`` (0 for a
  lane the trace may skip), the new RNG state and what K2 needs
  (``BounceSample``).
* K2 ``path_combine``: everything after the traces -- the NEE add where
  the shadow ray is unoccluded, the bounce hit's light pdf and ``mis_b``,
  the emission add where the bounce hit a light, ``continue_path``, the
  throughput and the path state (``PathState``).

Each has a plain PyTorch version here (``path_sample_plain``,
``path_combine_plain``): the arithmetic of the port's bounce cut in two,
no operation reordered, so the CPU results of ``path_color`` are the ones
it gave as one function.  The wrappers (``path_sample_cuda``,
``path_combine_cuda``) check their inputs, allocate the outputs and launch
the kernels of ``csrc/path_bounce.cu`` on the current stream, counting each
launch in ``LAUNCHES``.  Both sides are functional: they return new
tensors and update none in place, so the primary hit's fields, which
``render_tile`` turns into the g-buffers, are never written.

The kernels build with ``--fmad=false`` and repeat what the plain version
does on the card, where PyTorch divides by a Python scalar as a multiply
by its float reciprocal (``x / cm.PI`` is ``x * (1 / PI_f)``) and ``1.0 /
t`` is a reciprocal: so on a CUDA tensor the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import math as cm
from ..core import rng as rnglib
from ..core.types import SurfaceInteraction
from ..scene.device import DeviceScene
from ..shading import material
from ..shading.bsdf import EPS, cos_theta
from ..utils.launches import count_launch, span

# offset of secondary ray origins along the geometric normal
RAY_EPS = 1e-3
_INF = 3.0e38  # accel.traverse's t_max of a lane that traces

# Launches of each kernel since the last reset_launch_counts(), counted by
# utils.launches.count_launch (a CUDA graph's replays included); the plain
# versions are not counted.
LAUNCHES = {"path_sample": 0, "path_combine": 0}

# f32 operations a lane (adds, subtracts, multiplies, divisions, square
# roots, clamps, conversions, cosines and sines) as csrc/path_bounce.cu
# writes them, for the kernels' bounds: K1 the frame 55, the five draws 10,
# NEE 257 (light sample, shadow ray and its local direction 76, the BSDF
# pdf 66 and value 94 toward the light, the weights and the product 21), the
# BSDF sample 199, its value 94, the world direction 25 and 2 more; K2 50.
# Every lane computes all of them.
OPS_SAMPLE, OPS_COMBINE = 642, 50
# bytes a lane, each input read once and each output written once, for the
# kernels' bounds: K1 reads p, nrm, v, diffuse, tp (5 x 12), alpha, alive
# and rng (73) and writes the BounceSample (86), and each light's row (64)
# once; K2 reads color, the state but alive (76), what K1 wrote for it (46),
# occluded and the bounce hit (59) and writes color and the state (77)
BYTES_SAMPLE, BYTES_LIGHT, BYTES_COMBINE = 73 + 86, 64, 181 + 77

SOURCES = ["path_bounce.cu"]  # under csrc/
_lib = None


@dataclasses.dataclass
class PathState:
    """The path's state between bounces, one lane a primary ray: the
    current vertex (p, nrm), the direction back along the path (v), its
    material (diffuse, alpha), the throughput (tp) and ``alive``."""

    p: torch.Tensor  # (N, 3)
    nrm: torch.Tensor  # (N, 3)
    v: torch.Tensor  # (N, 3)
    diffuse: torch.Tensor  # (N, 3)
    alpha: torch.Tensor  # (N,)
    tp: torch.Tensor  # (N, 3)
    alive: torch.Tensor  # (N,) bool


@dataclasses.dataclass
class BounceSample:
    """What K1 writes: the shadow and bounce rays (one origin, each with
    its t_max), the RNG state after the bounce's five draws, and the
    per-lane values K2 combines with the traces' results."""

    origin: torch.Tensor  # (N, 3) p + nrm * RAY_EPS, both rays'
    shadow_dir: torch.Tensor  # (N, 3) toward the light sample
    shadow_t: torch.Tensor  # (N,) dist * (1 - 1e-3) where shadow_needed, else 0
    bounce_dir: torch.Tensor  # (N, 3) the BSDF sample in world space
    bounce_t: torch.Tensor  # (N,) INF where sample_ok, else 0
    rng: torch.Tensor  # (N,) int64
    nee: torch.Tensor  # (N, 3) the NEE contribution if unoccluded
    shadow_needed: torch.Tensor  # (N,) bool
    sample_ok: torch.Tensor  # (N,) bool
    brdf: torch.Tensor  # (N, 3) the BSDF value of the bounce sample
    cos_over_pdf: torch.Tensor  # (N,) cos_i / safe_pdf
    bsdf_pdf: torch.Tensor  # (N,)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a compiled ``path_bounce.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # path_sample: n; the state (7) and rng; the light tables (6) and their count; the BounceSample (12); stream
    lib.path_sample.argtypes = [i32] + [ptr] * 8 + [ptr] * 6 + [i32] + [ptr] * 12 + [ptr]
    lib.path_sample.restype = ctypes.c_int
    # path_combine: n, lights; color and the state (8); the sample (7); occluded and the bounce hit (9);
    # the new color and state (8); stream
    lib.path_combine.argtypes = [i32, i32] + [ptr] * 8 + [ptr] * 7 + [ptr] * 9 + [ptr] * 8 + [ptr]
    lib.path_combine.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernels (built from csrc/ at first use)."""
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_library

        _lib = bind_library(load_library("path_bounce", SOURCES))
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def pdf_area_to_solid_angle(pdf, dist2, cos_t):
    """pdfA2W (path.cuh:24-33)."""
    abs_cos = torch.abs(cos_t)
    small = abs_cos < 1e-8
    return torch.where(small, 0.0, pdf * dist2 / torch.where(small, 1.0, abs_cos))


def _clamp_dot(a, b):
    """clampDot(a, b, zero=false) = max(dot, EPS) (frostbite.cuh:13-16)."""
    return torch.clamp(cm.dot(a, b), min=EPS)


def gather_light_attrs(ds: DeviceScene, lidx: torch.Tensor):
    """Per-lane TriLight attribute fetch (sampleLight, path.cuh:6-14) as
    plain index gathers.  Returns (v1, v2, v3, normal, emit, area)."""
    i = lidx.long()
    return (ds.light_v1[i], ds.light_v2[i], ds.light_v3[i],
            ds.light_normal[i], ds.light_emit[i], ds.light_area[i])


def _local_frame(nrm, v):
    """The shading frame at the path vertex and wo in it."""
    to_local, to_world = cm.orthonormal_basis(nrm)
    wo_local = cm.normalize(cm.apply_mat(to_local, v), eps=1e-30)
    return to_local, to_world, wo_local


def _nee_plain(ds: DeviceScene, s: PathState, to_local, wo_local, l_u1, l_u2, l_pick):
    """NEE / light sampling (path.cuh:176-205, intended): (origin, shadow
    direction, shadow t_max, shadow_needed, unoccluded contribution)."""
    num_lights = ds.num_lights
    light_idx = torch.clamp((l_pick * num_lights).to(torch.int32), 0, num_lights - 1)
    lv1, lv2, lv3, lnormal, lemit, larea = gather_light_attrs(ds, light_idx)
    light_pdf_a = 1.0 / (larea * num_lights)
    lp = cm.sample_point_on_triangle(lv1, lv2, lv3, l_u1, l_u2)
    shadow_origin = s.p + s.nrm * RAY_EPS
    to_light = lp - shadow_origin
    dist2 = cm.dot(to_light, to_light)
    dist = cm.sqrt_rn(dist2)
    ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]

    light_pdf_w = pdf_area_to_solid_angle(light_pdf_a, dist2, cm.dot(-ldir, lnormal))
    wi_local_nee = cm.normalize(cm.apply_mat(to_local, ldir), eps=1e-30)
    brdf_pdf_nee = material.pdf(wi_local_nee, wo_local, s.diffuse, s.alpha)
    brdf_nee = material.evaluate(wi_local_nee, wo_local, s.diffuse, s.alpha)
    mis_nee = cm.balance_heuristic(1, light_pdf_w, 1, brdf_pdf_nee)

    # Lanes whose NEE contribution is provably zero (dead, zero light
    # pdf, light sample outside the BSDF hemisphere) trace with
    # t_max = 0: the kernel skips them, and ``occluded`` only feeds
    # nee_ok, which is false for them either way.
    shadow_needed = s.alive & (light_pdf_w > 0.0) & (brdf_nee != 0.0).any(dim=-1)
    shadow_t = torch.where(shadow_needed, dist * (1.0 - 1e-3), 0.0)
    nee = (
        mis_nee[:, None]
        * lemit
        * s.tp
        * brdf_nee
        * (_clamp_dot(s.nrm, ldir) / torch.where(light_pdf_w == 0.0, 1.0, light_pdf_w))[:, None]
    )
    return shadow_origin, ldir, shadow_t, shadow_needed, nee


def _bsdf_plain(s: PathState, to_world, wo_local, b_u1, b_u2):
    """BSDF sampling (path.cuh:207-245, intended): (bounce direction, its
    t_max, sample_ok, brdf, cos_i / safe_pdf, bsdf_pdf)."""
    wi_local, bsdf_pdf, valid = material.sample_direction(wo_local, b_u1, b_u2, s.diffuse, s.alpha)
    cos_i = cos_theta(wi_local)
    sample_ok = s.alive & valid & (bsdf_pdf > 0.0) & (cos_i > 0.0)

    brdf = material.evaluate(wi_local, wo_local, s.diffuse, s.alpha)
    dir_world = cm.normalize(cm.apply_mat(to_world, wi_local), eps=1e-30)
    # lanes that cannot contribute (dead, or an invalid BSDF sample) are
    # not traced: their hits are masked by sample_ok in path_combine
    bounce_t = torch.where(sample_ok, _INF, 0.0)
    safe_pdf = torch.where(bsdf_pdf == 0.0, 1.0, bsdf_pdf)
    return dir_world, bounce_t, sample_ok, brdf, cos_i / safe_pdf, bsdf_pdf


def path_sample_plain(ds: DeviceScene, s: PathState, rng: torch.Tensor) -> BounceSample:
    """K1's plain version: a bounce up to its traces."""
    with span("bounce.bsdf"):
        to_local, to_world, wo_local = _local_frame(s.nrm, s.v)
    rng, l_u1, l_u2 = rnglib.lcg_randomf2(rng)  # rand1 (path.cuh:165)
    rng, b_u1, b_u2 = rnglib.lcg_randomf2(rng)  # rand2 (path.cuh:166)
    rng, l_pick = rnglib.lcg_randomf(rng)  # light index (path.cuh:169)
    with span("bounce.nee"):
        origin, shadow_dir, shadow_t, shadow_needed, nee = _nee_plain(ds, s, to_local, wo_local, l_u1, l_u2, l_pick)
    with span("bounce.bsdf"):
        bounce_dir, bounce_t, sample_ok, brdf, cos_over_pdf, bsdf_pdf = _bsdf_plain(s, to_world, wo_local, b_u1,
                                                                                    b_u2)
    return BounceSample(origin=origin, shadow_dir=shadow_dir, shadow_t=shadow_t, bounce_dir=bounce_dir,
                        bounce_t=bounce_t, rng=rng, nee=nee, shadow_needed=shadow_needed, sample_ok=sample_ok,
                        brdf=brdf, cos_over_pdf=cos_over_pdf, bsdf_pdf=bsdf_pdf)


def path_combine_plain(num_lights: int, color: torch.Tensor, s: PathState, b: BounceSample,
                       occluded: torch.Tensor, bounce_si: SurfaceInteraction):
    """K2's plain version: the bounce after its traces.  Returns (color,
    the next PathState)."""
    nee_ok = b.shadow_needed & ~occluded
    color = color + torch.where(nee_ok[:, None], cm.check_positive(b.nee), 0.0)

    hit_light = b.sample_ok & bounce_si.hit & bounce_si.is_light
    dp = bounce_si.p - s.p
    d2 = cm.dot(dp, dp)
    lpdf_a = 1.0 / (torch.clamp(bounce_si.area, min=1e-20) * num_lights)
    # area -> solid angle with the cosine at the LIGHT surface, as in the
    # NEE arm, so the two strategies' balance weights sum to 1
    lpdf_w = pdf_area_to_solid_angle(lpdf_a, d2, cm.dot(-b.bounce_dir, bounce_si.n_geom))
    mis_b = cm.balance_heuristic(1, b.bsdf_pdf, 1, lpdf_w)
    emit_term = mis_b[:, None] * bounce_si.emit * s.tp * b.brdf * b.cos_over_pdf[:, None]
    color = color + torch.where(hit_light[:, None], cm.check_positive(emit_term), 0.0)

    # ---- advance (path.cuh:240, 249-252 with real alpha) -------------
    continue_path = b.sample_ok & bounce_si.hit & ~bounce_si.is_light
    new_tp = s.tp * b.brdf * b.cos_over_pdf[:, None]
    c = continue_path[:, None]
    return color, PathState(
        p=torch.where(c, bounce_si.p, s.p),
        nrm=torch.where(c, bounce_si.n_geom, s.nrm),
        v=torch.where(c, -b.bounce_dir, s.v),
        diffuse=torch.where(c, bounce_si.diffuse, s.diffuse),
        alpha=torch.where(continue_path, bounce_si.alpha, s.alpha),
        tp=torch.where(c, new_tp, s.tp),
        alive=continue_path,
    )


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(n: int, device: torch.device, named) -> None:
    """Each (name, tensor, components, dtype) on ``device``, contiguous, of
    shape (n, 3) for 3 components or (n,) for 1, and of the dtype."""
    if device.type != "cuda":
        raise ValueError(f"the path kernels take CUDA tensors, got {device}")
    for name, a, comps, dtype in named:
        shape = (n, 3) if comps == 3 else (n,)
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got {a.dtype} {tuple(a.shape)}")
        if a.device != device:
            raise ValueError(f"{name} must be on {device}, got {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous (got strides {a.stride()})")


def _state_inputs(s: PathState):
    f32 = torch.float32
    return (("p", s.p, 3, f32), ("nrm", s.nrm, 3, f32), ("v", s.v, 3, f32), ("diffuse", s.diffuse, 3, f32),
            ("alpha", s.alpha, 1, f32), ("tp", s.tp, 3, f32), ("alive", s.alive, 1, torch.bool))


def _light_inputs(ds: DeviceScene):
    lights = (ds.light_v1, ds.light_v2, ds.light_v3, ds.light_normal, ds.light_emit, ds.light_area)
    n_lights = ds.num_lights
    if n_lights == 0:
        raise ValueError("path_sample samples a light: the scene has none")
    for a in lights:
        if a.dtype != torch.float32 or not a.is_contiguous() or a.shape[0] != n_lights:
            raise ValueError(f"the scene's light tables must be contiguous float32 with {n_lights} rows")
    return lights, n_lights


def path_sample_cuda(ds: DeviceScene, s: PathState, rng: torch.Tensor) -> BounceSample:
    """K1 on the card; the same BounceSample as path_sample_plain."""
    n = s.p.shape[0]
    dev = s.p.device
    _check(n, dev, (*_state_inputs(s), ("rng", rng, 1, torch.int64)))
    lights, n_lights = _light_inputs(ds)
    for a in lights:
        if a.device != dev:
            raise ValueError(f"the scene's light tables must be on {dev}, got {a.device}")

    def vec3():
        return torch.empty((n, 3), dtype=torch.float32, device=dev)

    def lanes(dtype=torch.float32):
        return torch.empty((n,), dtype=dtype, device=dev)

    out = BounceSample(origin=vec3(), shadow_dir=vec3(), shadow_t=lanes(), bounce_dir=vec3(), bounce_t=lanes(),
                       rng=lanes(torch.int64), nee=vec3(), shadow_needed=lanes(torch.bool),
                       sample_ok=lanes(torch.bool), brdf=vec3(), cos_over_pdf=lanes(), bsdf_pdf=lanes())
    if n == 0:  # a grid of 0 blocks is an invalid launch
        return out
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.path_sample(
            n, s.p.data_ptr(), s.nrm.data_ptr(), s.v.data_ptr(), s.diffuse.data_ptr(), s.alpha.data_ptr(),
            s.alive.data_ptr(), s.tp.data_ptr(), rng.data_ptr(), *(a.data_ptr() for a in lights), n_lights,
            *(getattr(out, f.name).data_ptr() for f in dataclasses.fields(out)), stream)
    if err != 0:
        raise RuntimeError(f"path_sample launch failed: cudaError {err}")
    count_launch(LAUNCHES, "path_sample", "path_sample_kernel")
    return out


def path_combine_cuda(num_lights: int, color: torch.Tensor, s: PathState, b: BounceSample,
                      occluded: torch.Tensor, bounce_si: SurfaceInteraction):
    """K2 on the card; the same (color, PathState) as path_combine_plain."""
    n = s.p.shape[0]
    dev = s.p.device
    f32, b8 = torch.float32, torch.bool
    _check(n, dev, (
        ("color", color, 3, f32), *_state_inputs(s),
        ("nee", b.nee, 3, f32), ("shadow_needed", b.shadow_needed, 1, b8), ("sample_ok", b.sample_ok, 1, b8),
        ("brdf", b.brdf, 3, f32), ("cos_over_pdf", b.cos_over_pdf, 1, f32), ("bsdf_pdf", b.bsdf_pdf, 1, f32),
        ("bounce_dir", b.bounce_dir, 3, f32), ("occluded", occluded, 1, b8),
        ("bounce hit", bounce_si.hit, 1, b8), ("bounce is_light", bounce_si.is_light, 1, b8),
        ("bounce p", bounce_si.p, 3, f32), ("bounce n_geom", bounce_si.n_geom, 3, f32),
        ("bounce emit", bounce_si.emit, 3, f32), ("bounce area", bounce_si.area, 1, f32),
        ("bounce diffuse", bounce_si.diffuse, 3, f32), ("bounce alpha", bounce_si.alpha, 1, f32)))
    out_color = torch.empty_like(color)
    nxt = PathState(**{f.name: torch.empty_like(getattr(s, f.name)) for f in dataclasses.fields(PathState)})
    if n == 0:
        return out_color, nxt
    lib = kernel_library()
    state_ptrs = [getattr(s, f.name).data_ptr() for f in dataclasses.fields(PathState)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.path_combine(
            n, num_lights, color.data_ptr(), *state_ptrs,
            b.nee.data_ptr(), b.shadow_needed.data_ptr(), b.sample_ok.data_ptr(), b.brdf.data_ptr(),
            b.cos_over_pdf.data_ptr(), b.bsdf_pdf.data_ptr(), b.bounce_dir.data_ptr(),
            occluded.data_ptr(), bounce_si.hit.data_ptr(), bounce_si.is_light.data_ptr(), bounce_si.p.data_ptr(),
            bounce_si.n_geom.data_ptr(), bounce_si.emit.data_ptr(), bounce_si.area.data_ptr(),
            bounce_si.diffuse.data_ptr(), bounce_si.alpha.data_ptr(),
            out_color.data_ptr(), *(getattr(nxt, f.name).data_ptr() for f in dataclasses.fields(PathState)),
            stream)
    if err != 0:
        raise RuntimeError(f"path_combine launch failed: cudaError {err}")
    count_launch(LAUNCHES, "path_combine", "path_combine_kernel")
    return out_color, nxt
