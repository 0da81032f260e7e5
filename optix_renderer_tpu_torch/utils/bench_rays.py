"""Seeded ray batches at the shapes the main paths give the kernels, shared
by ``chip_smoke.py``, ``utils/brute_bench.py`` and the tests."""

from __future__ import annotations

import numpy as np
import torch

from ..core import rng as rnglib
from ..core.types import Ray
from ..engine.camera import primary_rays


def first_frame_primaries(renderer, lin: torch.Tensor) -> Ray:
    """The jittered primary rays of ``renderer``'s first frame for the pixel
    ids ``lin`` (``render_tile``: RNG stream 10007, two draws a pixel)."""
    st = rnglib.make_rng(10007, lin)
    st, ju = rnglib.lcg_randomf(st)
    st, jv = rnglib.lcg_randomf(st)
    return primary_rays(renderer.state.camera, renderer.width, renderer.height, ju, jv, lin=lin)


def bounce_like_rays(bvh, n: int, device, seed: int):
    """Rays leaving random points of the scene's triangles into the normal's
    hemisphere, offset like the path tracer's (1e-3 along the normal).
    Returns (origin, direction, t_max for a closest-hit trace, t_max for an
    occlusion trace); 30 % of each t_max are 0, as for the lanes the path
    tracer need not trace."""
    g = torch.Generator(device=device).manual_seed(seed)
    tri = torch.randint(0, bvh.num_tris, (n,), generator=g, device=device)
    su = torch.sqrt(torch.rand(n, generator=g, device=device))[:, None]
    b = torch.rand(n, generator=g, device=device)[:, None]
    p = bvh.tri_v0[tri] + su * (1.0 - b) * bvh.tri_e1[tri] + su * b * bvh.tri_e2[tri]
    nrm = bvh.tri_tab[tri, 10:13]  # the table's unit normal (sorted row = sorted triangle)
    d = torch.randn((n, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where(((d * nrm).sum(-1) < 0)[:, None], -d, d)
    o = (p + nrm * 1e-3).contiguous()
    zero = torch.rand(n, generator=g, device=device) < 0.3
    tm_closest = torch.where(zero, 0.0, 3.0e38)
    tm_any = torch.where(zero, 0.0, torch.rand(n, generator=g, device=device) * 1200.0)
    return o, d.contiguous(), tm_closest, tm_any


# the edge lanes of random_ltc_hits: lane k takes case k % 16 when it is one of these
LTC_EDGE_CASES = {9: "singular basis (n.z < -0.999999)", 10: "head-on wo", 11: "wo below the horizon",
                  12: "alpha 0.01", 13: "alpha 1", 14: "theta near pi/2", 15: "head-on wo, singular basis"}


def random_ltc_hits(n: int, n_lights: int, seed: int) -> dict:
    """Seeded hits and triangle lights for kernel B6, as numpy float32:
    ``origin``, ``p``, ``n_geom``, ``diffuse`` (n, 3), ``alpha`` (n,), and the
    lights' ``v1``, ``v2``, ``v3``, ``normal``, ``emit`` (n_lights, 3).

    The random lanes are those of tests/unit/test_ltc_pallas.py:26-50 (hits
    near the origin, unit normals, ray origins 0.5 to 5 away along a random
    direction, alpha in [0.01, 1)); lane k takes the edge case
    ``LTC_EDGE_CASES[k % 16]`` where there is one.  Lights sit around (0, 4,
    0); the even ones face down towards the hits and the odd ones up, away
    from most of them.
    """
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * 2.0
    nrm = rng.normal(size=(n, 3))
    wo = rng.normal(size=(n, 3))
    diffuse = rng.uniform(0, 1, size=(n, 3))
    alpha = rng.uniform(0.01, 1, size=(n,))
    dist = rng.uniform(0.5, 5.0, size=(n, 1))
    case = np.arange(n) % 16
    axes = np.concatenate([np.eye(3), -np.eye(3)[:2]])  # +x +y +z -x -y: a head-on wo_local has x = y = 0
    head_on = case == 10
    nrm[head_on] = axes[rng.integers(0, len(axes), int(head_on.sum()))]
    nrm[case == 9] = [1e-4, -2e-4, -1.0]
    nrm[case == 15] = [0.0, 0.0, -1.0]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((np.sum(wo * nrm, axis=1) < 0)[:, None], -wo, wo)  # above the horizon
    wo[case == 11] *= -1.0
    wo[(case == 10) | (case == 15)] = nrm[(case == 10) | (case == 15)]
    grazing = case == 14
    tangent = np.cross(nrm[grazing], rng.normal(size=(int(grazing.sum()), 3)))
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    wo[grazing] = tangent + 1e-4 * nrm[grazing]
    alpha[case == 12] = 0.01
    alpha[case == 13] = 1.0
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    p = f32(p)
    nrm = f32(nrm)
    # the axis-aligned head-on lanes: origin - p is exact along the normal
    origin = f32(np.where(((case == 10) | (case == 15))[:, None], p + nrm * np.float32(2.0), p + wo * dist))

    v1 = rng.normal(size=(n_lights, 3)) * 3 + np.array([0, 4, 0])
    v2 = v1 + rng.normal(size=(n_lights, 3))
    v3 = v1 + rng.normal(size=(n_lights, 3))
    lnorm = np.cross(v2 - v1, v3 - v1)
    lnorm /= np.linalg.norm(lnorm, axis=1, keepdims=True)
    flip = (lnorm[:, 1] > 0) == (np.arange(n_lights) % 2 == 0)  # even lights face down, odd ones up
    v2, v3 = np.where(flip[:, None], v3, v2), np.where(flip[:, None], v2, v3)
    lnorm = np.where(flip[:, None], -lnorm, lnorm)
    emit = rng.uniform(0, 5, size=(n_lights, 3))
    return {"origin": origin, "p": p, "n_geom": nrm, "alpha": f32(alpha), "diffuse": f32(diffuse),
            "v1": f32(v1), "v2": f32(v2), "v3": f32(v3), "normal": f32(lnorm), "emit": f32(emit)}


def ltc_frame_inputs(renderer) -> tuple:
    """Kernel B6's inputs in ``renderer``'s first frame, in the order the
    frame traces its pixels: (origin, p, n_geom, alpha, diffuse, lights) of
    the jittered primaries' closest hits (``render_tile``)."""
    from ..engine.camera_kernel import pixel_order
    from ..engine.shade import trace_closest_si
    from ..shading.ltc_kernel import light_table

    ds = renderer.device_scene
    rays = first_frame_primaries(renderer, pixel_order(renderer.width, renderer.height, renderer.device))
    si = trace_closest_si(ds, renderer.bvh, rays)
    return (rays.origin.contiguous(), si.p.contiguous(), si.n_geom.contiguous(), si.alpha.contiguous(),
            si.diffuse.contiguous(), light_table(ds.light_v1, ds.light_v2, ds.light_v3, ds.light_normal,
                                                 ds.light_emit))


def random_ltc_inputs(n: int, n_lights: int, seed: int, device) -> tuple:
    """``random_ltc_hits`` as kernel B6's inputs on ``device``:
    (origin, p, n_geom, alpha, diffuse, lights (n_lights, 16))."""
    from ..shading.ltc_kernel import pack_lights

    h = {k: torch.as_tensor(v, device=device) for k, v in random_ltc_hits(n, n_lights, seed).items()}
    return (h["origin"], h["p"], h["n_geom"], h["alpha"], h["diffuse"],
            pack_lights(h["v1"], h["v2"], h["v3"], h["normal"], h["emit"]))


def record_bounce_inputs(renderer) -> dict:
    """One eager ``_frame_impl`` frame of a PATH ``renderer`` on the card with the wrappers of K1, K2 and K3
    recording their arguments: {"sample": [(ds, state, rng)] a bounce, "combine": [...] a bounce, "shade":
    [(ds, hit)] a trace}.  Every argument is a tensor the frame made and no later step writes."""
    from ..engine import shade_kernel as sk
    from ..engine.renderer import _frame_impl
    from ..integrators import path_kernel as pk

    rec = {"sample": [], "combine": [], "shade": []}
    orig = (pk.path_sample_cuda, pk.path_combine_cuda, sk.brute_shade_cuda)

    def recorder(key, fn):
        def run(*args):
            rec[key].append(args)
            return fn(*args)
        return run

    pk.path_sample_cuda, pk.path_combine_cuda, sk.brute_shade_cuda = (
        recorder("sample", orig[0]), recorder("combine", orig[1]), recorder("shade", orig[2]))
    try:
        r = renderer
        _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=r.width, height=r.height,
                    path_depth=r.path_depth, ratio_samples=r.ratio_samples)
    finally:
        pk.path_sample_cuda, pk.path_combine_cuda, sk.brute_shade_cuda = orig
    return rec


def random_shade_hits(ds, n: int, seed: int, device):
    """``n`` seeded brute-tier hits on ``ds``'s triangles for K3: about a tenth of them misses, the rest a
    uniform triangle id and barycentrics with u + v <= 1."""
    from ..core.types import Hit

    g = torch.Generator(device=device).manual_seed(seed)
    tri = torch.randint(0, ds.tri_pack.shape[0], (n,), generator=g, device=device, dtype=torch.int32)
    tri = torch.where(torch.rand(n, generator=g, device=device) < 0.1, -1, tri)
    u = torch.rand(n, generator=g, device=device)
    v = torch.rand(n, generator=g, device=device) * (1.0 - u)
    return Hit(t=torch.ones_like(u), tri_id=tri, bary_u=u, bary_v=v)
