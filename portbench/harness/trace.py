"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CUPTI on the
card) over the first whole requests of the window, at least ``seconds``
of them, and the record the per-layer readers take from it.

The host's phases of each request (``set_camera``, ``render``,
``readback``) are named ranges; the traced window runs from the first
range's start to the last one's end.  The record holds every device
operation in that window (kernels, copies and fills, with their names and
durations), the union of their intervals (``busy_s``) and the idle gaps
between them, summed by the host phase that was running at each gap's
middle.  Counts the readers need beside the trace (frames, honest rays,
per-bounce lanes) are taken when the traced requests are done.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

PHASES = ("set_camera", "render", "readback")


class Tracer:
    def __init__(self, renderer, seconds: float):
        self.r, self.seconds = renderer, float(seconds)
        self.active = False
        self.prof = None
        self.counts: dict = {}

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.r.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.rays0 = self.r.metrics["rays_traced"]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.active = True

    def mark(self, name: str):
        return torch.profiler.record_function(name) if self.active else contextlib.nullcontext()

    def stop(self, reqs) -> None:
        if self.r.device.type == "cuda":
            torch.cuda.synchronize(self.r.device)
        self.prof.__exit__(None, None, None)
        self.active = False
        m = self.r.metrics
        self.counts = {"requests": len(reqs), "frames": sum(q.frames for q in reqs),
                       "rays": m["rays_traced"] - self.rays0, "alive_per_bounce": list(m["alive_per_bounce"])}

    def record(self) -> dict:
        """The traced window's record (read once the window has closed)."""
        t_read = time.perf_counter()
        host, dev = [], []
        for e in self.prof.profiler.kineto_results.events():
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if name in PHASES:
                    host.append((start, start + dur, name))
            elif not e.is_user_annotation() and name not in PHASES:
                dev.append((start, dur, name))
        host.sort()
        starts = [h[0] for h in host]
        lo = host[0][0] if host else 0
        hi = max((h[1] for h in host), default=0)
        dev = sorted(d for d in dev if lo <= d[0] < hi)
        busy = 0
        gaps: dict = {}
        cur_s = cur_e = None

        def gap(a, b):
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1  # the phases run one after another
            label = host[i][2] if i >= 0 and mid < host[i][1] else "between_requests"
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9

        prev_end = lo
        for s, d, _name in dev:
            e = min(s + d, hi)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > prev_end:
                    gap(prev_end, s)
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev_end = max(prev_end, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if hi > prev_end:
            gap(prev_end, hi)
        return {**self.counts, "window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
                "ops": [(name, d / 1e9) for _s, d, name in dev], "idle_gaps": gaps,
                "read_s": time.perf_counter() - t_read}


def breakdown(rec: dict, top: int = 10) -> dict:
    by_name: dict = {}
    for name, sec in rec["ops"]:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(rec["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
