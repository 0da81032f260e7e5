"""A frame split over several devices (counterpart of
``optix_renderer_tpu/parallel/sharding.py``).

The JAX module maps a frame over a 1-D TPU mesh with ``shard_map``; here
one host thread issues each device's share in turn over a list of
``torch.device``s (CUDA launches are asynchronous, so the devices run
together).  The list may name one device more than once: each entry is one
share, so ``[cuda:0, cuda:0]`` or eight CPU entries exercise the split on
one card or on the CPU.

* **Row split** (``make_sharded_frame_fn``, JAX :120-173): device i renders
  the ``height / n`` image rows starting at row ``i * height / n`` into an
  accumulator row shard of its own (``ShardedState``).  Pixel ids, and so
  the RNG streams, are absolute (``engine.renderer.render_tile``), so the
  image is bit-identical to one device's.  Every share gets the scene, the
  BVH and the baked primary table (``replicate``; the JAX frame functions
  drop the table, :86).  Gathering the image (``gather_state``,
  ``gather_rows``) is the only step that crosses devices.
* **spp split** (``make_spp_sharded_frame_fn``, JAX :60-118): device i
  renders the whole frame for ``accum_id + i``; the colors are added onto
  the accumulator on ``devices[0]`` in frame order, so one step is
  bit-equal to n sequential frames (the JAX ``psum`` matches them only up
  to summation order).

Each share renders through a ``engine.frame_graph.FrameSlot`` of its own
(``FrameSlots`` finds or makes it): on a card, replays of one captured
graph per (device, row range) after the share's first eager frame, so a
tile costs the host one replay.  Two shares of one card are two graphs
with two pools, each holding its share's temporaries.

``render_rows`` runs frames of a ``Renderer`` through the row split and
leaves the renderer as ``Renderer.render`` would: state, g-buffers, aux and
the honest ray count (the tiles' ``path_alive_counts`` summed).  Its tiles
(and so their graphs) are the renderer's one layout of slots until the
renderer renders a whole frame or changes its key.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.types import Camera, RenderState
from ..engine.frame_graph import FrameSlots
from ..engine.modes import RendererType
from ..engine.renderer import frames_to_run


def check_devices(devices, height: int | None = None) -> list[torch.device]:
    """The split's devices as ``torch.device``s.  Raises on an empty list,
    on a device other than CUDA or CPU, on a CUDA device that does not
    exist (never a CPU stand-in), and when ``height`` does not divide into
    as many row tiles."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("the split needs at least one device")
    for d in devices:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {d}: no CUDA device (torch.cuda.is_available() is false)")
            if (d.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"device {d}: no such CUDA device ({torch.cuda.device_count()} visible)")
        elif d.type != "cpu":
            raise ValueError(f"device {d}: the split runs on CUDA or CPU devices")
    if height is not None and height % len(devices):
        raise ValueError(f"height {height} must divide into {len(devices)} row tiles")
    return devices


def _to(x, device):
    """``x`` with every tensor in it (through nested dataclasses) on
    ``device``; ``Tensor.to`` returns the tensor itself on its own device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def replicate(x, devices) -> list:
    """One copy of ``x`` (a DeviceScene, BVH, BakedTable or None) per
    device."""
    return [_to(x, d) for d in devices]


@dataclasses.dataclass
class ShardedState:
    """The row split's progressive state: accumulator row shard i, (rows,
    width, 3), and a copy of the camera on device i."""

    accum: list[torch.Tensor]
    accum_id: int
    camera: list[Camera]


def shard_render_state(state: RenderState, devices) -> ShardedState:
    """Cut ``state``'s accumulator into ``len(devices)`` row shards, one on
    each device; the camera goes to every device."""
    rows = state.accum.shape[0] // len(devices)
    return ShardedState(accum=[state.accum[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(devices)],
                        accum_id=state.accum_id, camera=replicate(state.camera, devices))


def gather_rows(tiles: list, device):
    """Tiles (tensors, or dataclasses or dicts of them) stacked by rows on
    ``device``."""
    first = tiles[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in tiles])
    if isinstance(first, dict):
        return {k: gather_rows([t[k] for t in tiles], device) for k in first}
    return type(first)(**{f.name: gather_rows([getattr(t, f.name) for t in tiles], device)
                          for f in dataclasses.fields(first)})


def gather_state(state: ShardedState, device) -> RenderState:
    """The whole image's state on ``device``."""
    return RenderState(accum=gather_rows(state.accum, device), accum_id=state.accum_id,
                       camera=_to(state.camera[0], device))


def merge_aux(auxs: list, device) -> dict:
    """One frame's aux from its tiles on ``device``: ``path_alive_counts``
    summed, RATIO's (rows, width, c) buffers stacked by rows."""
    return {k: (sum(a[k].to(device) for a in auxs) if k == "path_alive_counts"
                else gather_rows([a[k] for a in auxs], device)) for k in auxs[0]}


def _row_frames(shares: FrameSlots, state: ShardedState, ds: list, bvh: list, baked_tab: list, n: int):
    """``n`` frames of every row tile, each tile's back to back:
    ``(state', gbuffers, aux, alive, live)`` as ``FrameSlot.frames`` gives
    them, per tile."""
    outs = [shares.slot(i, ds[i], bvh[i], baked_tab[i]).frames(
                RenderState(accum=state.accum[i], accum_id=state.accum_id, camera=state.camera[i]), baked_tab[i], n)
            for i in range(len(shares.devices))]
    new = ShardedState(accum=[o[0].accum for o in outs], accum_id=state.accum_id + n, camera=state.camera)
    return new, *([o[k] for o in outs] for k in range(1, 5))


def make_sharded_frame_fn(devices, mode: RendererType, width: int, height: int, path_depth: int = 10,
                          ratio_samples: int = 4):
    """``frame(state, ds, bvh, baked_tab) -> (state', gbuffers, aux)``: one
    frame, device i rendering row tile i through a ``FrameSlot`` of its
    own (on a card a replay of the tile's graph, after its first eager
    frame).  ``state`` is a ``ShardedState``; ``ds``, ``bvh`` and
    ``baked_tab`` are ``replicate`` lists; ``gbuffers`` and ``aux`` are
    per-tile lists (``gather_rows``, ``merge_aux``)."""
    devices = check_devices(devices, height)
    shares = FrameSlots((), devices, height // len(devices), mode=mode, width=width, height=height,
                        path_depth=path_depth, ratio_samples=ratio_samples)

    def frame(state: ShardedState, ds: list, bvh: list, baked_tab: list):
        return _row_frames(shares, state, ds, bvh, baked_tab, 1)[:3]

    return frame


def make_spp_sharded_frame_fn(devices, mode: RendererType, width: int, height: int, path_depth: int = 10,
                              ratio_samples: int = 4):
    """``frame(state, ds, bvh, baked_tab) -> (state', gbuffers, aux)``:
    ``len(devices)`` frames in one step, device i rendering the whole frame
    for ``state.accum_id + i`` through a ``FrameSlot`` of its own onto a
    zero accumulator.  ``state`` is a ``RenderState`` on ``devices[0]``; its
    accumulator takes the colors in frame order, so the step is bit-equal
    to as many sequential frames.  ``gbuffers`` and ``aux`` are per-frame
    lists."""
    devices = check_devices(devices)
    dev0 = devices[0]
    shares = FrameSlots((), devices, None, mode=mode, width=width, height=height, path_depth=path_depth,
                        ratio_samples=ratio_samples)
    zeros = [torch.zeros((height, width, 3), dtype=torch.float32, device=d) for d in devices]

    def frame(state: RenderState, ds: list, bvh: list, baked_tab: list):
        outs = [shares.slot(i, ds[i], bvh[i], baked_tab[i]).frames(  # every frame enqueued before any sum
                    RenderState(accum=zeros[i], accum_id=state.accum_id + i, camera=state.camera), baked_tab[i], 1)
                for i in range(len(devices))]
        accum = state.accum
        for o in outs:  # 0 + color: the frame's color
            accum = accum + o[0].accum.to(dev0)
        new = RenderState(accum=accum, accum_id=state.accum_id + len(devices), camera=state.camera)
        return new, [o[1] for o in outs], [o[2] for o in outs]

    return frame


def _synchronize(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def render_rows(r, devices, n_frames: int = 1) -> None:
    """``r.render(n_frames)`` through the row split over ``devices``: the
    same image, bit for bit.  Afterwards ``r.state`` (on ``r.device``),
    ``r.gbuffers``, ``r.aux`` (RATIO: the mean over this call's frames) and
    ``r.metrics`` are what ``r.render`` leaves.  The tiles' slots (and so
    their graphs) and the scene and BVH replicas are ``r``'s one layout
    (``Renderer._layout``): they stay for the next call over the same
    devices, until the renderer's key changes or it renders a whole frame,
    which drops them."""
    devices = check_devices(devices, r.height)
    with r._lock:  # the renderer's one layout: these tiles' slots replace its other slots and graphs
        shares = r._layout(devices, lambda: (replicate(r.device_scene, devices), replicate(r.bvh, devices)))
        state, mode, baked_tab = r.state, r.mode, r.baked_tab
    ds, bvh = shares.inputs
    t0 = time.perf_counter()
    n = frames_to_run(mode, state.accum_id, n_frames)
    alive = live = None
    if n:
        # the table on r's device: each tile copies it in when its origin moves
        state, gbs, auxs, alives, lives = _row_frames(shares, shard_render_state(state, devices), ds, bvh,
                                                      [baked_tab] * len(devices), n)
        with r._lock:
            r.state = gather_state(state, r.device)
        r.gbuffers = gather_rows(gbs, r.device)
        r.aux = merge_aux(auxs, r.device)
        if alives[0] is not None:
            alive = (sum(a.to(r.device) for a in alives), r.aux["path_alive_counts"])
        if lives[0] is not None:
            live = sum(t.to(r.device) for t in lives)
    _synchronize(devices)
    r.record_frames(time.perf_counter() - t0, n, alive, live)
