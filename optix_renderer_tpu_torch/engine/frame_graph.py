"""Several frames in one dispatch: the counterpart of ``_frames_scan_impl``
(``optix_renderer_tpu/engine/renderer.py:193-254``).

The JAX renderer runs the first n-1 frames of ``render(n)`` inside one jit
through ``lax.scan``.  Here the scan's step is ``frames_step``: one frame
done in place on static buffers (``FrameBuffers``).  It reads the carried
frame id, adds the frame's color to the accumulator, its per-mode buffers
(RATIO: ``ltc``, ``sto_direct``, ``sto_no_vis``; PATH: the (depth, 3)
``path_alive_counts``) and its trace statistics to sums, and advances the
frame id.  The RNG streams are keyed by the carried frame id and
``accum.add_(color)`` is the same f32 add as ``state.accum + color``, so
n-1 steps and one ordinary frame are bit-identical to n ordinary frames.

On the CPU the Renderer calls ``frames_step`` eagerly.  On a card
``FrameGraph`` captures it once as a CUDA graph and replays it: a frame
then costs the host one replay instead of a launch for each of its
thousands of kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.build import BVH
from ..accel.cluster import BakedTable, zero_trace_stats
from ..core.types import Camera, RenderState
from ..scene.device import DeviceScene
from ..shading import ltc_kernel
from ..utils import launches
from .modes import RendererType

# the per-mode buffers a frame adds to its sums: (name, trailing shape, dtype)
_SUMS = {
    RendererType.RATIO: (("ltc", (3,), torch.float32), ("sto_direct", (1,), torch.float32),
                         ("sto_no_vis", (1,), torch.float32)),
    RendererType.PATH: (("path_alive_counts", None, torch.int64),),  # (path_depth, 3)
}


@dataclasses.dataclass
class FrameBuffers:
    """The static tensors that ``frames_step`` reads and writes: the
    accumulator (H, W, 3), the frame id (0-d int64), the camera's four
    vectors, the sums of the per-mode buffers (RATIO (H, W, c) f32, PATH
    (depth, 3) int64) and of the trace statistics (0-d int64 each)."""

    accum: torch.Tensor
    frame_id: torch.Tensor
    camera: Camera
    sums: dict
    stats: dict

    @classmethod
    def for_frames(cls, mode: RendererType, width: int, height: int, path_depth: int, device) -> FrameBuffers:
        """Buffers for frames of ``mode`` at width x height (zeros; ``load`` fills them)."""
        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        sums = {name: zeros((height, width) + tail if tail else (path_depth, 3), dtype)
                for name, tail, dtype in _SUMS.get(RendererType(mode), ())}
        return cls(accum=zeros((height, width, 3)), frame_id=zeros((), torch.int64),
                   camera=Camera(*(zeros(3) for _ in range(4))), sums=sums,
                   stats={k: zeros((), torch.int64) for k in zero_trace_stats()})

    def load(self, state: RenderState) -> None:
        """Start from ``state``: its accumulator and camera copied in, the
        frame id set on the device (a kernel argument, no host copy), the
        sums zeroed.  ``state`` itself is left as it is."""
        self.accum.copy_(state.accum)
        for name in ("pos", "dir_00", "dir_du", "dir_dv"):
            getattr(self.camera, name).copy_(getattr(state.camera, name))
        self.frame_id.fill_(state.accum_id)
        for t in (*self.sums.values(), *self.stats.values()):
            t.zero_()


def frames_step(buf: FrameBuffers, ds: DeviceScene, bvh: BVH, baked_tab: BakedTable | None, *,
                mode: RendererType, width: int, height: int, path_depth: int, ratio_samples: int) -> None:
    """One frame of the scan (JAX renderer.py:226-240), in place on ``buf``."""
    from .renderer import render_tile  # renderer imports this module

    color, _gb, aux, stats = render_tile(buf.camera, buf.frame_id, ds, bvh, mode=mode, width=width, height=height,
                                         path_depth=path_depth, ratio_samples=ratio_samples, baked_tab=baked_tab)
    buf.accum.add_(color.reshape(height, width, 3))
    for name, total in buf.sums.items():
        total.add_(aux[name])
    for name, total in buf.stats.items():
        total.add_(stats[name])
    buf.frame_id.add_(1)


class FrameGraph:
    """``frames_step`` on one set of buffers, captured once as a CUDA graph
    (with its own memory pool) and replayed.

    ``key`` names what the capture fixed: the Renderer's mode and shape and
    the identity of its scene, BVH and baked table.  The graph holds every
    tensor its replays read, so no captured address is freed under it.
    Capture only after an eager frame of the same key has run in the
    process: first uses (constant uploads, the light table, the kernels'
    module loading, cub's workspace) must not happen inside a capture.  A
    capture that fails raises; nothing falls back to eager frames.  The
    capture's own pass runs no kernel and counts none; every replay counts
    the launches it recorded (``utils.launches``).
    """

    def __init__(self, key: tuple, buf: FrameBuffers, ds: DeviceScene, bvh: BVH, baked_tab: BakedTable | None,
                 **static):
        if buf.accum.device.type != "cuda":
            raise ValueError(f"FrameGraph captures CUDA work; the buffers are on {buf.accum.device} "
                             "(call frames_step on them instead)")
        self.key = key
        self.graph = torch.cuda.CUDAGraph()
        with launches.recording() as tally, torch.cuda.graph(self.graph):
            frames_step(buf, ds, bvh, baked_tab, **static)
        self.recorded = tally  # the launches of one replay
        # what the replays read and write; B6's light table comes from a cache that another scene's frame
        # may refill, so hold the one the capture took
        self._inputs = (buf, ds, bvh, baked_tab, ltc_kernel._light_table)

    def replay(self) -> None:
        """One more frame: the captured kernels on the current stream."""
        self.graph.replay()
        launches.add(self.recorded)
