"""One dispatch for every frame: the counterpart of ``_frame_jit`` /
``_jitted_frame_fn`` and ``_frames_scan_impl``
(``optix_renderer_tpu/engine/renderer.py:193-285``).

The JAX renderer runs each single frame as one jitted call and the first
n-1 frames of ``render(n)`` inside one jit through ``lax.scan``.  Here a
frame is ``frames_step``: one frame done in place on static buffers
(``FrameBuffers``).  It reads the carried frame id, the camera and the
baked primary table from the buffers, adds the frame's color to the
accumulator, its per-mode buffers (RATIO: ``ltc``, ``sto_direct``,
``sto_no_vis``; PATH: the (depth, 3) ``path_alive_counts``) to sums,
RATIO's live-lane count to its counter, advances the frame id and returns
the frame's own (g-buffers, aux).  The
RNG streams are keyed by the carried frame id and ``accum.add_(color)`` is
the same f32 add as ``state.accum + color``, so n steps are bit-identical
to n ``_frame_impl`` frames.

``FrameSlot`` runs every frame of one key on one set of buffers: on a card
the first eagerly, then replays of one captured CUDA graph
(``FrameGraph``), whose static outputs are the tensors ``frames_step``
returned while it was captured; on the CPU eager ``frames_step`` calls.
A frame then costs the host one replay instead of a launch for each of its
thousands of kernels.  The Renderer (``render``, ``render_step_detached``)
and every share of the multi-device split (``parallel.sharding``) take
their frames from slots, which ``FrameSlots`` finds or makes for a layout
of shares; a Renderer holds one layout, so one set of graphs, at a time.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..accel.build import BVH
from ..accel.cluster import BakedTable
from ..core.types import Camera, GBuffers, RenderState
from ..scene.device import DeviceScene
from ..shading import ltc_kernel
from ..utils import launches
from ..utils.launches import span
from .modes import RendererType

# the per-mode buffers a frame adds to its sums: (name, trailing shape, dtype)
_SUMS = {
    RendererType.RATIO: (("ltc", (3,), torch.float32), ("sto_direct", (1,), torch.float32),
                         ("sto_no_vis", (1,), torch.float32)),
    RendererType.PATH: (("path_alive_counts", None, torch.int64),),  # (path_depth, 3)
}


def _graphs(device: torch.device) -> bool:
    """Are frames on ``device`` replays of a captured graph
    (``FrameGraph``)?  On a CUDA device only."""
    return device.type == "cuda"


@dataclasses.dataclass
class FrameBuffers:
    """The static tensors that ``frames_step`` reads and writes for the
    tile of ``rows`` image rows from ``row_offset``: the accumulator (rows,
    W, 3), the frame id (0-d int64), the camera's four vectors, the table
    baked for the primaries' shared origin (a copy; None where the
    primaries take none), the sums of the per-mode buffers (RATIO (rows,
    W, c) f32, PATH (depth, 3) int64) and RATIO's counter of live lanes
    (0-d int64, summed over the frames; None in other modes)."""

    accum: torch.Tensor
    frame_id: torch.Tensor
    camera: Camera
    baked: BakedTable | None
    sums: dict
    row_offset: int
    rows: int
    live: torch.Tensor | None = None

    @classmethod
    def for_frames(cls, mode: RendererType, width: int, height: int, path_depth: int, device, *,
                   row_offset: int = 0, rows: int | None = None,
                   baked_tab: BakedTable | None = None) -> FrameBuffers:
        """Buffers for frames of ``mode`` over rows [row_offset, row_offset
        + rows) (default: the whole width x height frame), zeros that
        ``load`` fills; with a table shaped like ``baked_tab`` where one is
        given."""
        rows = height if rows is None else rows

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        sums = {name: zeros((rows, width) + tail if tail else (path_depth, 3), dtype)
                for name, tail, dtype in _SUMS.get(RendererType(mode), ())}
        baked = None
        if baked_tab is not None:  # no origin yet: the first load copies the table in
            baked = BakedTable(tab=zeros(tuple(baked_tab.tab.shape), baked_tab.tab.dtype),
                               origin=np.full(3, np.nan, np.float32))
        live = zeros((), torch.int64) if RendererType(mode) == RendererType.RATIO else None
        return cls(accum=zeros((rows, width, 3)), frame_id=zeros((), torch.int64),
                   camera=Camera(*(zeros(3) for _ in range(4))), baked=baked, sums=sums, row_offset=row_offset,
                   rows=rows, live=live)

    def load(self, state: RenderState, baked_tab: BakedTable | None = None) -> None:
        """Start from ``state`` (its accumulator of this tile's rows) and
        ``baked_tab``: the accumulator and camera copied in, the frame id
        set on the device (a kernel argument, no host copy), the table
        copied only when its origin differs from the one the buffers hold
        (decided on the host), the sums and the counter zeroed.  ``state`` and ``baked_tab``
        are left as they are."""
        if (baked_tab is None) != (self.baked is None):
            raise ValueError("these buffers were made for frames "
                             f"{'with' if self.baked is not None else 'without'} a baked primary table")
        self.accum.copy_(state.accum)
        for name in ("pos", "dir_00", "dir_du", "dir_dv"):
            getattr(self.camera, name).copy_(getattr(state.camera, name))
        self.frame_id.fill_(state.accum_id)
        if baked_tab is not None and not np.array_equal(self.baked.origin, baked_tab.origin):
            self.baked.tab.copy_(baked_tab.tab)  # the same address: a captured graph reads the new table
            self.baked = dataclasses.replace(self.baked, origin=np.array(baked_tab.origin, np.float32))
        for t in self.sums.values():
            t.zero_()
        if self.live is not None:
            self.live.zero_()


def frames_step(buf: FrameBuffers, ds: DeviceScene, bvh: BVH, *, mode: RendererType, width: int, height: int,
                path_depth: int, ratio_samples: int):
    """One frame (JAX renderer.py:226-240), in place on ``buf``; returns
    the frame's own (g-buffers (rows, W, ...), aux)."""
    from .renderer import render_tile  # renderer imports this module

    color, gb, aux, live = render_tile(buf.camera, buf.frame_id, ds, bvh, mode=mode, width=width, height=height,
                                       path_depth=path_depth, ratio_samples=ratio_samples, baked_tab=buf.baked,
                                       row_offset=buf.row_offset, rows=buf.rows)
    with span("frame.accumulate"):
        buf.accum.add_(color.reshape(buf.rows, width, 3))
        for name, total in buf.sums.items():
            total.add_(aux[name])
        if buf.live is not None:
            buf.live.add_(live)
        buf.frame_id.add_(1)
    return gb, aux


class FrameGraph:
    """``frames_step`` on one set of buffers, captured once as a CUDA graph
    (with its own memory pool) and replayed.

    ``key`` names what the capture fixed (``FrameSlot``).  The tensors
    ``frames_step`` returned during the capture are the graph's static
    outputs (``outputs``), rewritten by every replay.  The graph holds
    every tensor its replays read, so no captured address is freed under
    it.  Capture only after an eager frame of the same key has run in the
    process: first uses (constant uploads, the light table, the kernels'
    module loading, cub's workspace) must not happen inside a capture.  A
    capture that fails raises; nothing falls back to eager frames.  The
    capture's own pass runs no kernel and counts none; every replay counts
    the launches it recorded (``utils.launches``).  ``stages``: the stage
    map of the capture (``utils.launches.stage_map``: the ``frame.*`` span
    that made each node a replay runs, and the hand kernels' nodes), None
    where the nodes cannot be counted (no libcuda).  Other threads may use
    the card while a capture runs (the viewer's HTTP threads copy committed
    frames): the capture checks only its own thread's calls.
    """

    def __init__(self, key: tuple, buf: FrameBuffers, ds: DeviceScene, bvh: BVH, **static):
        if buf.accum.device.type != "cuda":
            raise ValueError(f"FrameGraph captures CUDA work; the buffers are on {buf.accum.device} "
                             "(call frames_step on them instead)")
        self.key = key
        self.graph = torch.cuda.CUDAGraph()
        with span("frame_graph.capture"), launches.recording() as tally, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"), \
                launches.stage_map("frame_graph.capture") as stages:
            self.outputs = frames_step(buf, ds, bvh, **static)
        self.recorded = tally  # the launches of one replay
        self.stages = stages or None  # the stage of each node a replay runs (launches.stage_map)
        # what the replays read and write; B6's light table comes from a cache that another scene's frame
        # may refill, so hold the one the capture took
        self._inputs = (buf, ds, bvh, ltc_kernel._light_table)

    def replay(self):
        """One more frame, the captured kernels on the current stream;
        returns the static outputs (g-buffers, aux)."""
        with span("frame_graph.replay"):
            self.graph.replay()
        launches.add(self.recorded)
        return self.outputs


class FrameSlot:
    """Every frame of one key on one set of buffers: on a card the first
    eagerly, then replays of one ``FrameGraph`` captured for the key; on
    the CPU eager ``frames_step`` calls.

    ``key``: what the frames fix, the mode, shape and tile, which scene and
    BVH they read, and whether the primaries take a baked table (whose
    origin the buffers take in ``load``: a camera move keeps the key).  The
    buffers and the graph's outputs are one set of addresses, so ``frames``
    holds a lock from the load to the last clone, and the next user's
    stream waits for an event recorded after that user's clones: two
    threads on two streams take turns, in order.
    """

    def __init__(self, key: tuple, buf: FrameBuffers, ds: DeviceScene, bvh: BVH, **static):
        self.key, self.buf = key, buf
        self.graph: FrameGraph | None = None
        self._ds, self._bvh, self._static = ds, bvh, static
        self._warm = False  # has a frame of the key run eagerly?
        self._lock = threading.Lock()
        self._done: torch.cuda.Event | None = None  # recorded after the last user's clones

    def _step(self):
        if self.graph is None and self._warm and _graphs(self.buf.accum.device):
            self.graph = FrameGraph(self.key, self.buf, self._ds, self._bvh, **self._static)
        if self.graph is not None:
            return self.graph.replay()
        with span("frame_graph.eager"):
            out = frames_step(self.buf, self._ds, self._bvh, **self._static)
        self._warm = True
        return out

    def frames(self, state: RenderState, baked_tab: BakedTable | None, n: int):
        """``n`` >= 1 frames from ``state``: ``(state', gbuffers, aux,
        alive, live)``, clones that the next user of the buffers does not
        touch.  ``aux``: RATIO's buffers as the mean over the n frames (JAX
        renderer.py:473-480), PATH's last frame's ``path_alive_counts``.
        Summed over the n frames: ``alive``, PATH's ``path_alive_counts``,
        and ``live``, RATIO's live lanes (0-d); None in other modes.  On a
        card the work is only enqueued, on the current stream."""
        if n < 1:
            raise ValueError(f"frames needs n >= 1, got {n}")
        buf = self.buf
        cuda = buf.accum.device.type == "cuda"
        with self._lock:
            stream = torch.cuda.current_stream(buf.accum.device) if cuda else None
            if self._done is not None:
                stream.wait_event(self._done)
            try:
                with span("frame_graph.load"):
                    buf.load(state, baked_tab)
                for _ in range(n):
                    gb, aux = self._step()
                with span("frame_graph.clone"):
                    new = RenderState(accum=buf.accum.clone(), accum_id=state.accum_id + n, camera=state.camera)
                    gbuffers = GBuffers(**{f.name: getattr(gb, f.name).clone() for f in dataclasses.fields(gb)})
                    alive = buf.sums.get("path_alive_counts")
                    if alive is not None:
                        aux, alive = {"path_alive_counts": aux["path_alive_counts"].clone()}, alive.clone()
                    else:  # the mean, so denoise and combine see n_samples * n shadow samples a pixel
                        aux = {k: v / n for k, v in buf.sums.items()}  # (deviceCode.cu:117-144)
                    live = None if buf.live is None else buf.live.clone()
            finally:
                if cuda:
                    self._done = torch.cuda.Event()
                    self._done.record(stream)
        return new, gbuffers, aux, alive, live


class FrameSlots:
    """The slots of one layout of frames over ``devices``: share i renders
    the row tile of ``rows`` rows from ``i * rows`` on ``devices[i]`` or,
    where ``rows`` is None, the whole frame (the Renderer's own frames, a
    share of the spp split).  ``key`` is the owner's name for what all its
    frames fix (a Renderer's frame key); ``inputs`` the scenes and BVHs the
    owner keeps with the layout, one a share, if any.

    ``slot`` is the one place a slot is found or made: the share's slot
    while its key holds (the owner's key, the tile, the scene and BVH it
    reads, whether a baked table exists), else a new one, which drops the
    old one and its graph.  One graph per (device, row range)."""

    def __init__(self, key: tuple, devices, rows: int | None, *, inputs: tuple | None = None,
                 mode: RendererType, width: int, height: int, path_depth: int, ratio_samples: int):
        self.key, self.devices, self.rows, self.inputs = key, list(devices), rows, inputs
        self.static = dict(mode=RendererType(mode), width=width, height=height, path_depth=path_depth,
                           ratio_samples=ratio_samples)
        self.slots: list[FrameSlot | None] = [None] * len(self.devices)

    def slot(self, i: int, ds: DeviceScene, bvh: BVH, baked_tab: BakedTable | None) -> FrameSlot:
        row_offset = 0 if self.rows is None else i * self.rows
        key = (self.key, self.devices[i], row_offset, self.rows, id(ds), id(bvh), baked_tab is not None)
        slot = self.slots[i]
        if slot is None or slot.key != key:
            slot = self.slots[i] = None  # the old graph goes before the new buffers
            s = self.static
            buf = FrameBuffers.for_frames(s["mode"], s["width"], s["height"], s["path_depth"], self.devices[i],
                                          row_offset=row_offset, rows=self.rows, baked_tab=baked_tab)
            slot = self.slots[i] = FrameSlot(key, buf, ds, bvh, **s)
        return slot
