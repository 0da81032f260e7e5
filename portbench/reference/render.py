"""The plain reference renderer: chosen pixels of chosen frames, worked out
again from the scene's tables (``reference.scene``) and the cameras, in
plain PyTorch, on any device and in any float dtype.

It imports nothing of the renderer under test.  Its arithmetic is a frozen
copy of the estimator the renderer states (the reference renderer's
deviceCode.cu / path.cuh / material.cuh / frostbite.cuh in their intended
form): the camera basis of viewer.hpp:634-641, jittered primary rays, the
32-bit LCG seeded by MurmurHash3 of (pixel, frame id + 10007), Lambert +
GGX with balance-heuristic MIS between light sampling and BSDF sampling,
written in the same order of operations, so that in float32 a pixel
agrees with the renderer to rounding unless a path takes another branch.
The trace is brute force over every triangle (no-cull Moller-Trumbore,
the closest hit with the lowest triangle index among equal distances),
in blocks of rays and triangles so that a million triangles fit.

``dtype`` is the precision of every float tensor: float32 is the
reference; bfloat16 is the control that ``portbench/control.py`` shows
to fail the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265358979323846
EPS = 1e-5
RAY_EPS = 1e-3
INF = 3.0e38
BLOCK = 1 << 16  # triangles a block of the trace
_MASK = 0xFFFFFFFF


# --------------------------------------------------------------------- RNG
def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl32(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def _mix(h, k):
    k = _rotl32(_mul32(k, 0xCC9E2D51), 15)
    k = _mul32(k, 0x1B873593)
    h = _rotl32(h ^ k, 13)
    return (_mul32(h, 5) + 0xE6546B64) & _MASK


def _fmix(h):
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def make_rng(frame_ids: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    """int64 LCG states in [0, 2^32) of lanes (frame id, linear pixel id)."""
    idx = pixels.to(torch.int64) & _MASK
    h = _mix(torch.zeros_like(idx), idx)
    h = _mix(h, frame_ids.to(torch.int64) & _MASK)
    return _fmix(h)


def draw(state: torch.Tensor, dtype):
    state = (_mul32(state, 1664525) + 1013904223) & _MASK
    return state, (state.to(torch.float32) * (2.0 ** -32)).to(dtype)


# -------------------------------------------------------------------- math
def sqrt(x):
    if x.device.type == "cpu" and x.dtype == torch.float32:  # correctly rounded, as the card's sqrtf
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(a, eps=0.0):
    n2 = dot(a, a)
    if eps > 0.0:
        inv = torch.where(n2 > eps, sqrt(torch.clamp(n2, min=1e-38)), 1.0)
        return a / inv[..., None]
    return a * (1.0 / sqrt(n2))[..., None]


def apply_mat(m, v):
    return torch.stack([dot(m[..., 0, :], v), dot(m[..., 1, :], v), dot(m[..., 2, :], v)], dim=-1)


def _unit(i, value, like):
    v = like.new_zeros(3)
    v[i] = value
    return v


def orthonormal_basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < -0.999999
    a = 1.0 / torch.where(singular, 1.0, 1.0 + nz)
    b = -nx * ny * a
    c1 = normalize(torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1), eps=1e-30)
    c2 = normalize(torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1), eps=1e-30)
    c1 = torch.where(singular[..., None], _unit(1, -1.0, c1), c1)
    c2 = torch.where(singular[..., None], _unit(0, -1.0, c2), c2)
    to_local = torch.stack([c1, c2, n], dim=-2)
    return to_local, to_local.transpose(-1, -2)


def balance(f_pdf, g_pdf):
    return f_pdf / (f_pdf + g_pdf)


# ------------------------------------------------------------------- BSDF
def _cos2(w):
    return w[..., 2] * w[..., 2]


def _tan2(w):
    c2 = _cos2(w)
    return torch.clamp(1.0 - c2, min=0.0) / torch.where(c2 == 0.0, 1e-30, c2)


def _same_hemi(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def _d_ggx(wh, alpha):
    a2 = alpha * alpha
    a = 1.0 + _cos2(wh) * (a2 - 1.0)
    return a2 / (PI * a * a)


def _lambda(w, alpha):
    return (-1.0 + sqrt(alpha * alpha * _tan2(w) + 1.0)) / 2.0


def _g1(w, alpha):
    return torch.where(_tan2(w) > 1e5, 0.0, 1.0 / (1.0 + _lambda(w, alpha)))


def _g2(wi, wo, alpha):
    g = 1.0 / (1.0 + _lambda(wo, alpha) + _lambda(wi, alpha))
    return torch.where((_tan2(wo) > 1e5) | (_tan2(wi) > 1e5), 0.0, g)


def _ggx_reflection(wi, wo, f0, alpha):
    wh = wi + wo
    wh2 = wh[..., 0] * wh[..., 0] + wh[..., 1] * wh[..., 1] + wh[..., 2] * wh[..., 2]
    valid = _same_hemi(wi, wo) & (wi[..., 2] != 0.0) & (wo[..., 2] != 0.0) & (wh2 > 0.0)
    wh = wh / sqrt(torch.where(wh2 > 0.0, wh2, 1.0))[..., None]
    cos_t = dot(wi, wh)
    a = torch.clamp(1.0 - torch.abs(cos_t), min=0.0)
    a5 = (a * a) * (a * a) * a
    schlick = f0 + (1.0 - f0) * a5[..., None]
    f = torch.where((cos_t * cos_t > 0.0)[..., None], schlick, 1.0)
    denom = 4.0 * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2])
    val = f * (_g2(wi, wo, alpha) * _d_ggx(wh, alpha) / torch.where(denom == 0.0, 1.0, denom))[..., None]
    return torch.where(valid[..., None], val, 0.0)


def bsdf_eval(wi, wo, base, alpha):
    diffuse = torch.where(_same_hemi(wi, wo)[..., None], base / PI, 0.0)
    return 0.5 * diffuse + 0.5 * _ggx_reflection(wi, wo, base, alpha * alpha)


def _lobes(base):
    m = base.amax(dim=-1)
    pd, ps = m * 0.5, m
    norm = 1.0 / torch.where(pd + ps == 0.0, 1.0, pd + ps)
    return pd * norm, ps * norm


def _pdf_cos(wi, wo):
    return torch.where(_same_hemi(wi, wo), wi[..., 2] / PI, 0.0)


def _pdf_vndf(wi, wo, alpha):
    wh = normalize(wi + wo, eps=1e-30)
    cos_wo = torch.abs(wo[..., 2])
    pdf_h = _g1(wo, alpha) * _d_ggx(wh, alpha) * torch.abs(dot(wh, wo))
    pdf_h = pdf_h / torch.where(cos_wo == 0.0, 1.0, cos_wo)
    dwi = dot(wi, wh)
    return torch.where(_same_hemi(wi, wo), pdf_h * (1.0 / torch.where(dwi == 0.0, 1e-30, 4.0 * dwi)), 0.0)


def bsdf_pdf(wi, wo, base, alpha):
    pd, ps = _lobes(base)
    return pd * _pdf_cos(wi, wo) + ps * _pdf_vndf(wi, wo, alpha)


def _remap(value, low1, high1, low2, high2):
    den = high1 - low1
    return torch.clamp(low2 + (value - low1) * (high2 - low2) / torch.where(den == 0.0, 1.0, den), low2, high2)


def _vndf_sample(wo, alpha, u1, u2):
    a = alpha[..., None]
    wo_h = normalize(torch.cat([a * wo[..., :2], wo[..., 2:3]], dim=-1), eps=1e-30)
    l2 = wo_h[..., 0] ** 2 + wo_h[..., 1] ** 2
    inv = 1.0 / sqrt(torch.where(l2 > 0.0, l2, 1.0))
    b1 = torch.stack([-wo_h[..., 1] * inv, wo_h[..., 0] * inv, torch.zeros_like(inv)], dim=-1)
    b1 = torch.where((l2 > 0.0)[..., None], b1, _unit(0, 1.0, wo))
    b2 = cross(wo_h, b1)
    r = sqrt(u1)
    phi = 2.0 * PI * u2
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + wo_h[..., 2])
    t2 = (1.0 - s) * sqrt(torch.clamp(1.0 - t1 * t1, min=0.0)) + s * t2
    wh_h = (t1[..., None] * b1 + t2[..., None] * b2
            + sqrt(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))[..., None] * wo_h)
    wh = torch.cat([a * wh_h[..., :2], torch.clamp(wh_h[..., 2:3], min=0.0)], dim=-1)
    return normalize(wh, eps=1e-30)


def bsdf_sample(wo, u1, u2, base, alpha):
    """(wi, pdf, valid) in the local frame: the diffuse lobe with
    probability 1/3, the GGX visible-normal lobe with 2/3."""
    pd, ps = _lobes(base)
    c = torch.where(wo[..., 2] == 0.0, 1.0, wo[..., 2])
    sign = torch.sign(c)
    pick_d = u1 < pd
    u1_d = _remap(u1, 0.0, pd - EPS, 0.0, 1.0 - EPS)
    ct = sqrt(torch.clamp(1.0 - u1_d, min=0.0))
    st = sqrt(u1_d)
    phi = 2.0 * PI * u2
    wi_d = normalize(sign[..., None] * torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1), eps=1e-30)
    u1_s = _remap(u1, pd, pd + ps - EPS, 0.0, 1.0 - EPS)
    wh = sign[..., None] * _vndf_sample(sign[..., None] * wo, alpha, u1_s, u2)
    d = dot(wo, wh)
    wi_s = 2.0 * d[..., None] * wh - wo
    valid = pick_d | ((d >= 0.0) & _same_hemi(wi_s, wo))
    wi = torch.where(pick_d[..., None], wi_d, wi_s)
    return wi, pd * _pdf_cos(wi, wo) + ps * _pdf_vndf(wi, wo, alpha), valid


# ------------------------------------------------------------------ scene
class RefScene:
    """The scene's tables as tensors of ``dtype`` on ``device``."""

    def __init__(self, tables: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype

        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(dtype)

        v = np.asarray(tables["v"], np.float32)
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        # the triangle test's nine columns, each (T,)
        self.cols = [f(c) for c in (*v[:, 0].T, *e1.T, *e2.T)]
        self.v = f(v)
        self.n = f(tables["n"])
        self.diffuse = f(tables["diffuse"])
        self.alpha = f(tables["alpha"])
        self.emit = f(tables["emit"])
        self.is_light = torch.as_tensor(tables["is_light"], device=self.device)
        a = v[:, 0] - v[:, 1]
        b = v[:, 2] - v[:, 1]
        self.area = f(0.5 * np.linalg.norm(np.cross(a, b), axis=-1).astype(np.float32))
        self.light_v = f(tables["light_v"])
        self.light_normal = f(tables["light_normal"])
        self.light_emit = f(tables["light_emit"])
        self.light_area = f(tables["light_area"])
        self.num_tris = v.shape[0]
        self.num_lights = int(tables["light_v"].shape[0])
        # triangle blocks of BLOCK rows in table order, each with its bounding box grown by a margin,
        # so that a ray is tested only against the blocks its segment enters
        lo = np.stack([v[i:i + BLOCK].reshape(-1, 3).min(axis=0) for i in range(0, len(v), BLOCK)])
        hi = np.stack([v[i:i + BLOCK].reshape(-1, 3).max(axis=0) for i in range(0, len(v), BLOCK)])
        pad = 1e-3 * float(np.max(hi.max(axis=0) - lo.min(axis=0))) + 1e-3
        self.block_lo = torch.as_tensor(lo - pad, device=self.device)
        self.block_hi = torch.as_tensor(hi + pad, device=self.device)


# ------------------------------------------------------------------ trace
def _mt(cols, o, d):
    """No-cull Moller-Trumbore of rays (R, 1) against triangles (1, T)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = cols
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


def _entered(scene: RefScene, o, d, t_max):
    """(R, blocks) bool: does the segment o + t d, 0 <= t <= t_max, enter
    each triangle block's box?  Float32 slab test, conservative by the
    boxes' margin."""
    o, d, t_max = o.float(), d.float(), t_max.float()
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t1 = (scene.block_lo[None] - o[:, None]) * inv[:, None]
    t2 = (scene.block_hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    return (near <= far) & (far >= 0.0) & (near <= t_max[:, None])


def trace(scene: RefScene, origin, direction, t_max, closest: bool, pairs: int = 1 << 24):
    """Closest hit (t, tri id or -1, u, v) or occlusion (bool) of rays with
    ``0 < t < t_max``; a ray with t_max <= 0 hits nothing.  Blocks go in
    table order and a later block wins only a strictly nearer hit, so the
    lowest triangle index wins among equal distances."""
    n = origin.shape[0]
    dt = origin.dtype
    t_best = t_max.clone()
    tid = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    ub = torch.zeros(n, dtype=dt, device=origin.device)
    vb = torch.zeros_like(ub)
    occ = torch.zeros(n, dtype=torch.bool, device=origin.device)
    live = torch.nonzero(t_max > 0.0).flatten()
    if live.numel() == 0:
        return (t_best, tid, ub, vb) if closest else occ
    enters = _entered(scene, origin[live], direction[live], t_max[live])
    rays_per_call = max(1, pairs // min(scene.num_tris, BLOCK))
    for b in range(enters.shape[1]):
        t0 = b * BLOCK
        cols = [c[None, t0:t0 + BLOCK] for c in scene.cols]
        rays = live[enters[:, b]]
        for r0 in range(0, rays.numel(), rays_per_call):
            idx = rays[r0:r0 + rays_per_call]
            o = [origin[idx, k][:, None] for k in range(3)]
            d = [direction[idx, k][:, None] for k in range(3)]
            tcur = t_best[idx]
            hit, t, u, v = _mt(cols, o, d)
            hit = hit & (t < tcur[:, None])
            if not closest:
                occ[idx] |= hit.any(dim=1)
                continue
            tmin, j = torch.where(hit, t, INF).min(dim=1)  # the first index among equal minima
            upd = hit.gather(1, j[:, None])[:, 0] & (tmin < tcur)
            t_best[idx] = torch.where(upd, tmin, tcur)
            tid[idx] = torch.where(upd, j + t0, tid[idx])
            ub[idx] = torch.where(upd, u.gather(1, j[:, None])[:, 0], ub[idx])
            vb[idx] = torch.where(upd, v.gather(1, j[:, None])[:, 0], vb[idx])
    return (t_best, tid, ub, vb) if closest else occ


def shade(scene: RefScene, tid, u, v):
    """The hit's surface: (hit, p, n, diffuse, alpha, emit, is_light, area);
    misses are black with a zero normal."""
    hit = tid >= 0
    i = torch.clamp(tid, min=0)
    uu, vv = u[:, None], v[:, None]
    w = 1.0 - uu - vv
    tv = scene.v[i]
    tn = scene.n[i]
    p = w * tv[:, 0] + uu * tv[:, 1] + vv * tv[:, 2]
    n = normalize(w * tn[:, 0] + uu * tn[:, 1] + vv * tn[:, 2], eps=1e-30)
    m = hit[:, None]
    return {
        "hit": hit,
        "p": torch.where(m, p, 0.0),
        "n": torch.where(m, n, 0.0),
        "diffuse": torch.where(m, scene.diffuse[i], 0.0),
        "alpha": torch.where(hit, torch.clamp(scene.alpha[i], 0.01, 1.0), 0.0),
        "emit": torch.where(m, scene.emit[i], 0.0),
        "is_light": hit & scene.is_light[i],
        "area": torch.where(hit, scene.area[i], 0.0),
    }


# ----------------------------------------------------------------- camera
def camera_basis(from_, at, up, cos_fovy, width, height):
    """viewer.hpp:634-641 in float32 numpy: (pos, d00, du, dv)."""
    from_, at, up = (np.asarray(x, np.float32) for x in (from_, at, up))
    d00 = at - from_
    d00 = d00 / np.linalg.norm(d00)
    du = np.cross(d00, up)
    du = cos_fovy * (width / float(height)) * du / np.linalg.norm(du)
    dv = np.cross(du, d00)
    dv = cos_fovy * dv / np.linalg.norm(dv)
    d00 = d00 - 0.5 * du - 0.5 * dv
    return [np.asarray(x, np.float32) for x in (from_, d00, du, dv)]


def primary(scene: RefScene, cam, width, height, pixels, frame_ids):
    """Jittered primary rays and the lanes' RNG states."""
    dt, dev = scene.dtype, scene.device
    pos, d00, du, dv = (torch.as_tensor(x, device=dev).to(dt) for x in cam)
    rng = make_rng(frame_ids + 10007, pixels)
    rng, ju = draw(rng, dt)
    rng, jv = draw(rng, dt)
    x = (pixels % width).to(dt)
    y = (pixels // width).to(dt)
    uu = (x + ju) / float(width)
    vv = (y + jv) / float(height)
    d = d00[None, :] + uu[:, None] * du[None, :] + vv[:, None] * dv[None, :]
    d = d / sqrt(dot(d, d))[:, None]
    return pos[None, :].expand(pixels.shape[0], 3).contiguous(), d, rng


def _to_solid_angle(pdf, dist2, cos_t):
    c = torch.abs(cos_t)
    small = c < 1e-8
    return torch.where(small, 0.0, pdf * dist2 / torch.where(small, 1.0, c))


def path_lanes(scene: RefScene, o, d, rng, depth: int):
    """PATH radiance of each lane (unidirectional, NEE + BSDF sampling with
    balance-heuristic MIS, ``depth`` bounces, EPS floor)."""
    n = o.shape[0]
    dt = scene.dtype
    t, tid, u, v = trace(scene, o, d, torch.full((n,), INF, dtype=dt, device=o.device), True)
    si = shade(scene, tid, u, v)
    p, nrm = si["p"], si["n"]
    wv = normalize(o - p, eps=1e-30)
    diffuse, alpha = si["diffuse"], si["alpha"]
    tp = torch.ones((n, 3), dtype=dt, device=o.device)
    alive = si["hit"] & ~si["is_light"]
    color = torch.zeros((n, 3), dtype=dt, device=o.device)
    L = scene.num_lights
    for _ in range(depth):
        to_local, to_world = orthonormal_basis(nrm)
        wo = normalize(apply_mat(to_local, wv), eps=1e-30)
        rng, l_u1 = draw(rng, dt)
        rng, l_u2 = draw(rng, dt)
        rng, b_u1 = draw(rng, dt)
        rng, b_u2 = draw(rng, dt)
        rng, l_pick = draw(rng, dt)
        # light sample (NEE)
        li = torch.clamp((l_pick * L).to(torch.int32), 0, L - 1).long()
        lv = scene.light_v[li]
        lpdf_a = 1.0 / (scene.light_area[li] * L)
        su1 = sqrt(l_u1)[:, None]
        u2e = l_u2[:, None]
        lp = (1.0 - su1) * lv[:, 0] + su1 * ((1.0 - u2e) * lv[:, 1] + u2e * lv[:, 2])
        origin = p + nrm * RAY_EPS
        to_light = lp - origin
        dist2 = dot(to_light, to_light)
        dist = sqrt(dist2)
        ldir = to_light / torch.clamp(dist, min=1e-30)[:, None]
        lpdf_w = _to_solid_angle(lpdf_a, dist2, dot(-ldir, scene.light_normal[li]))
        wi_nee = normalize(apply_mat(to_local, ldir), eps=1e-30)
        bpdf_nee = bsdf_pdf(wi_nee, wo, diffuse, alpha)
        f_nee = bsdf_eval(wi_nee, wo, diffuse, alpha)
        mis_nee = balance(lpdf_w, bpdf_nee)
        need = alive & (lpdf_w > 0.0) & (f_nee != 0.0).any(dim=-1)
        shadow_t = torch.where(need, dist * (1.0 - 1e-3), 0.0)
        nee = (mis_nee[:, None] * scene.light_emit[li] * tp * f_nee
               * (torch.clamp(dot(nrm, ldir), min=EPS) / torch.where(lpdf_w == 0.0, 1.0, lpdf_w))[:, None])
        # BSDF sample
        wi, pdf, valid = bsdf_sample(wo, b_u1, b_u2, diffuse, alpha)
        ok = alive & valid & (pdf > 0.0) & (wi[..., 2] > 0.0)
        f_b = bsdf_eval(wi, wo, diffuse, alpha)
        bdir = normalize(apply_mat(to_world, wi), eps=1e-30)
        cos_over_pdf = wi[..., 2] / torch.where(pdf == 0.0, 1.0, pdf)
        # the two traces
        occluded = trace(scene, origin, ldir, shadow_t, False)
        bt, btid, bu, bv = trace(scene, origin, bdir, torch.where(ok, INF, 0.0).to(dt), True)
        b = shade(scene, btid, bu, bv)
        # combine
        color = color + torch.where((need & ~occluded)[:, None], torch.clamp(nee, min=0.0), 0.0)
        hit_light = ok & b["hit"] & b["is_light"]
        dp = b["p"] - p
        lpdf_b = _to_solid_angle(1.0 / (torch.clamp(b["area"], min=1e-20) * L), dot(dp, dp), dot(-bdir, b["n"]))
        mis_b = balance(pdf, lpdf_b)
        emit_term = mis_b[:, None] * b["emit"] * tp * f_b * cos_over_pdf[:, None]
        color = color + torch.where(hit_light[:, None], torch.clamp(emit_term, min=0.0), 0.0)
        go = ok & b["hit"] & ~b["is_light"]
        g = go[:, None]
        new_tp = tp * f_b * cos_over_pdf[:, None]
        p = torch.where(g, b["p"], p)
        nrm = torch.where(g, b["n"], nrm)
        wv = torch.where(g, -bdir, wv)
        diffuse = torch.where(g, b["diffuse"], diffuse)
        alpha = torch.where(go, b["alpha"], alpha)
        tp = torch.where(g, new_tp, tp)
        alive = go
    out = torch.where(si["is_light"][:, None], si["emit"], torch.clamp(color, min=EPS))
    return torch.where(si["hit"][:, None], out, 0.0)


def render_pixels(scene: RefScene, cam, width: int, height: int, pixels: np.ndarray, frames: int, *,
                  path_depth: int = 4, lanes: int = 1 << 18) -> np.ndarray:
    """The displayed PATH value (P, 3) float64 of ``pixels`` (linear ids
    ``x + y * width``, row 0 at the bottom) after ``frames`` frames from the
    camera ``cam`` = (from, to, up, cos_fovy): the mean of frames 0 ..
    frames - 1, summed in frame order as the accumulation buffer does."""
    basis = camera_basis(*cam, width, height)
    px = torch.as_tensor(np.asarray(pixels, np.int64), device=scene.device)
    acc = torch.zeros((px.numel(), 3), dtype=scene.dtype, device=scene.device)
    per = max(1, lanes // max(px.numel(), 1))  # frames a batch of lanes
    for f0 in range(0, frames, per):
        nf = min(per, frames - f0)
        fid = torch.arange(f0, f0 + nf, device=scene.device).repeat_interleave(px.numel())
        pix = px.repeat(nf)
        o, d, rng = primary(scene, basis, width, height, pix, fid)
        c = path_lanes(scene, o, d, rng, path_depth)
        for k in range(nf):
            acc = acc + c[k * px.numel():(k + 1) * px.numel()]
    return (acc / float(max(frames, 1))).double().cpu().numpy()
