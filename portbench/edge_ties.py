"""Why the program and the plain reference part on a cell: the pixels the
output check counts as off, traced back to the rays whose answers differ.

    python3 portbench/edge_ties.py --workload <name> --seeds <n> [<n> ...] [--requests 3] [--device cuda]

For each seed it takes the first ``requests`` cameras of the traffic (the
requests a run of that seed serves first, all of them checked when the
window holds that many) and the seed's sampled pixels, and renders each
request four ways:

* ``program``: the renderer under test, served as the traffic driver
  serves a request (``set_camera``, ``render``, ``image``);
* ``reference``: the plain reference in float32, the check's answer;
* ``swapped``: the plain reference with every trace it makes answered by
  the renderer's own trace (``accel.traverse``: the walks on the card) on
  the same rays, the primaries through the table baked for the camera as
  in a frame;
* ``float64``: the plain reference in float64.

One JSON line a request: ``off_pixels_pct`` (``check.off_share``) of
program, swapped and float64 against reference and of program against
swapped; ``off_flagged_pct``, the share of the program's off pixels with a
lane whose trace answers differed in the swapped render; and for each
trace kind (primary, shadow, bounce) the rays whose answers differ, each
classified in float64 from the ray and the two answers' triangles, with
``ulp`` = (the origin's largest coordinate + the hit's distance) x 2^-23,
the float32 rounding step of the ray's reach:

* ``tie``: both answers hit, their two triangles share an edge or a
  vertex, and the ray passes within ``ULPS`` ulp of it (a ray moved
  there hits both at one distance);
* ``graze``: the nearer of the two answers' triangles (where one answer
  is a miss, the other's; for a shadow ray, the nearest blocker the
  occluded answer saw) is hit within ``ULPS`` ulp of one of its edges, so
  the other answer passed its edge (a shadow ray also where the blocker
  lies at the end of the segment within ``ULPS`` ulp);
* ``other``: neither, a difference rounding does not explain.

and how far the differing rays pass from that edge or vertex, in ulp, as
counts in the bins ``BINS`` (``differ_ulps_hist``), beside the same counts
for the nearest edge of every hit of the reference (``hits_ulps_hist``), the
rate of such passes by chance.  Triangle ids are
compared as the reference numbers them (the renderer's are mapped by
their vertices).  It runs no part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ULPS = 16  # rounding steps of the ray's reach within which a difference is rounding's
BINS = (1, 2, 4, 8, 16, 64)  # ulp: the histograms' bin edges, a last bin above 64
_STEP = 2.0 ** -23


def off_mask(prog: np.ndarray, ref: np.ndarray, rel_tol: float) -> np.ndarray:
    """The pixels ``check.off_share`` counts as off."""
    mag = np.abs(ref).max(axis=1)
    floor = 0.01 * max(float(mag.mean()), 1e-30)
    return ~(np.abs(prog - ref).max(axis=1) / np.maximum(mag, floor) <= rel_tol)


def _mt_t(tri, o, d):
    """Distance along each ray to its triangle's plane, float64."""
    import torch

    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    q = torch.linalg.cross(o - tri[:, 0], e1)
    return (e2 * q).sum(-1) / (e1 * torch.linalg.cross(d, e2)).sum(-1)


def _seg_dist(o, d, p, q):
    """Distance from the lines o + s d (d unit) to the segments [p, q]."""
    u, w = q - p, p - o
    pu = u - (u * d).sum(-1, keepdim=True) * d
    pw = w - (w * d).sum(-1, keepdim=True) * d
    s = (-(pu * pw).sum(-1) / (pu * pu).sum(-1).clamp(min=1e-300)).clamp(0.0, 1.0)
    return (pw + s[:, None] * pu).norm(dim=-1)


def _edge_dist(tri, o, d):
    """Distance from each ray to the nearest edge of its triangle."""
    import torch

    return torch.stack([_seg_dist(o, d, tri[:, i], tri[:, (i + 1) % 3]) for i in range(3)]).amin(0)


def _shared_dist(ta, tb, o, d):
    """(distance from each ray to what triangles ``ta`` and ``tb`` share,
    their edge or their vertex (inf where nothing), shared vertices)."""
    import torch

    shared = (ta[:, :, None, :] == tb[:, None, :, :]).all(-1).any(-1)  # (N, 3): a's corner is one of b's
    n = shared.sum(-1)
    first = torch.argsort((~shared).to(torch.int8), dim=1, stable=True)  # shared corners first
    p = ta[torch.arange(len(ta)), first[:, 0]]
    q = torch.where((n >= 2)[:, None], ta[torch.arange(len(ta)), first[:, 1]], p)
    return torch.where(n > 0, _seg_dist(o, d, p, q), torch.inf), n


class Comparer:
    """The reference's ``trace`` answered by the renderer's trace, each
    answer held against the reference's own on the same rays."""

    def __init__(self, ref_trace, bvh, baked, v64, to_ref, depth: int):
        self.ref_trace, self.bvh, self.baked, self.v64, self.to_ref = ref_trace, bvh, baked, v64, to_ref
        self.per_path = 1 + 2 * depth  # path_lanes: the primaries, then a shadow and a bounce trace a bounce
        self.calls = 0
        self.flags: list = []  # one (lanes,) bool a path_lanes call: a trace answer differed
        self.kinds = {k: {"rays": 0, "differ": 0, "tie": 0, "graze": 0, "other": 0, "shares_vertex": 0,
                          "same_tri_t_rel_max": 0.0, "differ_ulps_hist": [0] * (len(BINS) + 1),
                          "hits_ulps_hist": [0] * (len(BINS) + 1)}
                      for k in ("primary", "shadow", "bounce")}
        self.kinds["primary"]["differ_unbaked_walk"] = 0

    def _port(self, kind, o, d, t_max, baked: bool = True):
        import torch

        from optix_renderer_tpu_torch.accel import cluster, traverse
        from optix_renderer_tpu_torch.core.types import Ray

        rays = Ray(origin=o.float().contiguous(), direction=d.float().contiguous())
        tm = t_max.float().contiguous()
        if kind == "shadow":
            occ, _ = traverse.trace_any_with_stats(self.bvh, rays, t_max=tm, refine=True, coherent=False)
            return occ
        if kind == "primary" and baked and self.baked is not None and bool(
                (rays.origin == torch.as_tensor(self.baked.origin, device=o.device)).all()):
            key, cid, t_eff, _ = traverse.trace_closest_winners(self.bvh, rays, tm, coherent=True, baked_tab=self.baked)
            hit = cluster.decode_hits(key, cid, self.bvh.tri_tab, rays, t_eff)
        else:
            hit = traverse.trace_closest(self.bvh, rays, t_max=tm, coherent=kind == "primary")
        tid = hit.tri_id.long()
        tid = torch.where(tid >= 0, self.to_ref[tid.clamp(min=0)], -1)
        return hit.t.to(o.dtype), tid, hit.bary_u.to(o.dtype), hit.bary_v.to(o.dtype)

    def _ulp(self, o, t):
        return (o.abs().amax(-1) + t.clamp(min=0.0)) * _STEP

    @staticmethod
    def _hist(acc: list, ratio) -> None:
        import torch

        edges = torch.as_tensor(BINS, dtype=ratio.dtype, device=ratio.device)
        for i, n in enumerate(torch.bincount(torch.bucketize(ratio, edges, right=True), minlength=len(acc)).tolist()):
            acc[i] += n

    def __call__(self, scene, origin, direction, t_max, closest: bool, pairs: int = 1 << 24):
        import torch

        pos = self.calls % self.per_path
        self.calls += 1
        kind = "primary" if pos == 0 else ("shadow" if not closest else "bounce")
        if pos == 0:
            self.flags.append(torch.zeros(origin.shape[0], dtype=torch.bool, device=origin.device))
        want = self.ref_trace(scene, origin, direction, t_max, closest, pairs)
        got = self._port(kind, origin, direction, t_max)
        k = self.kinds[kind]
        live = t_max > 0
        k["rays"] += int(live.sum())
        o64, d64 = origin.double(), direction.double()
        d64 = d64 / d64.norm(dim=-1, keepdim=True).clamp(min=1e-300)
        if closest:
            t_r, id_r = want[0], want[1]
            differ = live & (id_r != got[1])
            same = live & (id_r == got[1]) & (id_r >= 0)
            if same.any():
                rel = ((t_r[same] - got[0][same]).abs() / t_r[same].abs()).max()
                k["same_tri_t_rel_max"] = max(k["same_tri_t_rel_max"], float(rel))
            hits = live & (id_r >= 0)
            self._hist(k["hits_ulps_hist"], _edge_dist(self.v64[id_r[hits]], o64[hits], d64[hits])
                       / self._ulp(o64[hits], t_r[hits].double()))
            if kind == "primary" and self.baked is not None:
                k["differ_unbaked_walk"] += int((live & (id_r != self._port(kind, origin, direction, t_max, False)[1])).sum())
        else:
            differ = live & (want != got)
        self.flags[-1] |= differ
        idx = torch.nonzero(differ).flatten()
        if idx.numel() == 0:
            return got
        k["differ"] += idx.numel()
        o, d = o64[idx], d64[idx]
        if closest:
            a, b = id_r[idx], got[1][idx]
            va, vb = self.v64[a.clamp(min=0)], self.v64[b.clamp(min=0)]
            ta, tb = _mt_t(va, o, d), _mt_t(vb, o, d)
            both = (a >= 0) & (b >= 0)
            ulp = ULPS * self._ulp(o, torch.where(a >= 0, ta, tb))
            dist, n = _shared_dist(va, vb, o, d)
            tie = both & (n > 0) & (dist <= ulp)
            nearer = torch.where(((a < 0) | (both & (tb < ta)))[:, None, None], vb, va)
            edge = _edge_dist(nearer, o, d)
            graze = ~tie & (edge <= ulp)
            dist = torch.where(tie, dist, edge)
            k["shares_vertex"] += int((both & (n > 0)).sum())
        else:
            # the nearest blocker the occluding answer saw
            tm = t_max[idx]
            blk = torch.where(want[idx], self.ref_trace(scene, origin[idx], direction[idx], tm, True, pairs)[1],
                              self._port("bounce", origin[idx], direction[idx], tm)[1])
            vt = self.v64[blk.clamp(min=0)]
            tt = _mt_t(vt, o, d)
            ulp = ULPS * self._ulp(o, tt)
            dist = torch.where((tt - tm.double()).abs() <= ulp, 0.0, _edge_dist(vt, o, d))
            tie = torch.zeros_like(blk, dtype=torch.bool)
            graze = (blk >= 0) & (dist <= ulp)
        other = ~tie & ~graze
        k["tie"] += int(tie.sum())
        k["graze"] += int(graze.sum())
        k["other"] += int(other.sum())
        self._hist(k["differ_ulps_hist"], dist / (ulp / ULPS))
        return got


@contextlib.contextmanager
def _swapped_trace(render_mod, comparer):
    ref_trace = render_mod.trace
    render_mod.trace = comparer
    try:
        yield comparer
    finally:
        render_mod.trace = ref_trace


def reference_ids(port_tris: np.ndarray, ref_tris: np.ndarray) -> np.ndarray:
    """The reference's id of each of the renderer's triangles (same three
    corners in the same order), -1 where none."""
    where = {t.tobytes(): j for j, t in enumerate(np.ascontiguousarray(ref_tris, np.float32))}
    return np.asarray([where.get(t.tobytes(), -1) for t in np.ascontiguousarray(port_tris, np.float32)], np.int64)


def edge_ties(workload: str, seed: int, device: str, requests: int = 3, overrides: dict | None = None, log=print):
    import torch

    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer
    from optix_renderer_tpu_torch.scene.config import parse_scene
    from portbench.harness import check, traffic
    from portbench.harness.cell import _merge
    from portbench.harness.manifest import CACHE_DIR, cell_spec, scene_json
    from portbench.reference import render as ref
    from portbench.reference.scene import load_scene

    spec = _merge(cell_spec(workload), overrides)
    cfg, tr, chk = spec["config"], spec["traffic"], spec["check"]
    driver = traffic.load_driver(tr["driver"])
    width, height, rel_tol = int(cfg["width"]), int(cfg["height"]), float(chk["rel_tol"])
    tables = load_scene(scene_json(cfg), CACHE_DIR)
    ref32, ref64 = ref.RefScene(tables, device, torch.float32), ref.RefScene(tables, device, torch.float64)
    v64 = torch.as_tensor(tables["v"], device=device).double()
    kw = dict(tr["renderer"])
    mode = RendererType[kw.pop("mode")]
    r = Renderer(parse_scene(scene_json(cfg)), width=width, height=height, mode=mode, device=device,
                 bvh_cache_dir=os.path.join(CACHE_DIR, "bvh"), **kw)
    tri = r.device_scene.vertices[r.device_scene.tri_index.long()].cpu().numpy()
    ids = reference_ids(tri, tables["v"])
    unmatched = int((ids < 0).sum())
    to_ref = torch.as_tensor(ids, device=device)
    pixels = check.sampled_pixels(width, height, int(chk["pixels"]), seed)
    cams = list(itertools.islice(driver.cameras(tr, tables["cameras"][0], seed), requests))
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        prog = driver.serve(r, tr, traffic.Request(cam), pixels).sample
        want = driver.reference(ref32, tr, cam, width, height, pixels)
        wide = driver.reference(ref64, tr, cam, width, height, pixels)
        comparer = Comparer(ref.trace, r.bvh, r.baked_tab, v64, to_ref, int(kw.get("path_depth", 4)))
        with _swapped_trace(ref, comparer):
            swapped = driver.reference(ref32, tr, cam, width, height, pixels)
        flagged = torch.stack([f.view(-1, len(pixels)) for f in comparer.flags]).flatten(0, 1).any(0).cpu().numpy()
        off = off_mask(prog, want, rel_tol)
        line = {
            "workload": workload, "seed": seed, "request": i, "unmatched_triangles": unmatched,
            "off_pixels_pct": {
                "program_vs_reference": check.off_share(prog, want, rel_tol),
                "swapped_vs_reference": check.off_share(swapped, want, rel_tol),
                "program_vs_swapped": check.off_share(prog, swapped, rel_tol),
                "float64_vs_reference": check.off_share(wide, want, rel_tol)},
            "flagged_pixels_pct": 100.0 * float(flagged.mean()),
            "off_flagged_pct": 100.0 * float(flagged[off].mean()) if off.any() else None,
            "swapped_off_unflagged": int((off_mask(swapped, want, rel_tol) & ~flagged).sum()),
            "rays": comparer.kinds, "ulps": ULPS, "ulps_bins": BINS, "seconds": time.perf_counter() - t0}
        log(json.dumps(line))
    return unmatched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        edge_ties(args.workload, seed, args.device, args.requests, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
