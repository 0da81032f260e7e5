"""Progressive renderer: frame function + accumulation (counterpart of
``optix_renderer_tpu/engine/renderer.py``; reference
cuda_src/deviceCode.cu:59-175).

Each frame returns a new state whose ``accum`` is the old one plus the
frame's color, leaving its input state as it was (the JAX ``_frame_impl``
is a pure function too); the displayed image divides by the frame count
(deviceCode.cu:158-174).  RATIO's extra buffers
(``aux``: ltc, sto_direct, sto_no_vis) are the mean over the frames of the
last :meth:`Renderer.render` call, as in the JAX package.  The host
issues every frame and so knows ``accum_id`` without asking the device.
Every frame goes through ``engine.frame_graph`` (the JAX ``_frame_jit``
and ``_frames_scan_impl``): a ``FrameSlot`` of the Renderer's key, whose
frames are replays of one captured CUDA graph on a card after the key's
one eager frame, and eager ``frames_step`` calls on the CPU.
``_frame_impl`` stays as the pure reference that the tests and
``chip_smoke.py`` hold them against; no frame on the card calls it.  The
host syncs of :meth:`Renderer.render` are the one
``torch.cuda.synchronize()`` at its end and the one a capture makes.

Primary rays go in square pixel blocks of up to 32 x 32 (JAX
renderer.py:72-96): the 32 rays of a warp of the cluster tier's walk are
then neighbours in both directions, where 32 row-major rays are a line
one pixel tall.  RNG streams are keyed by the absolute pixel id, so the
image does not depend on the order.

On the cluster tier on a CUDA device the primaries all start at the camera
position, so the Renderer keeps the table baked for it
(``accel.cluster.bake_shared_origin_tab``) and every frame's primary trace
takes the baked walk (JAX renderer.py:99-107, 293-305).  The bake is paid
per camera move (``set_camera``, ``load_checkpoint``), never per frame: a
camera whose position equals the table's origin, decided on the host,
keeps the table.  The CPU never bakes, as in the JAX package.

A frame renders one tile of rows (``render_tile``: the whole frame here,
a row shard of it in ``parallel.sharding``), with absolute pixel ids, so a
split image is bit-identical to a whole one.  The live viewer
(``engine.serve``) renders frames off a snapshot of (state, mode, baked
table) with :meth:`Renderer.render_step_detached` and adopts or drops them
with :meth:`Renderer.commit_step`; the renderer's lock makes each setter's
(state, table) pair one step for a snapshot.  A camera move keeps the
frame graph (the buffers take the new table); a new mode, shape, scene or
BVH drops it.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..accel.build import BRUTE_MAX_TRIS, BVH, build_bvh_cached, pack_attr_tab
from ..accel.cluster import BakedTable, bake_shared_origin_tab
from ..core.types import Camera, GBuffers, RenderState
from ..scene.config import Scene, SceneCamera
from ..scene.device import DeviceScene, build_device_scene
from ..utils.launches import span
from . import camera as cameralib
from .camera_kernel import block_dim, camera_rng
from .frame_graph import FrameSlot, FrameSlots
from .modes import DETERMINISTIC_MODES, GBUFFER_MODES, RendererType
from .shade import trace_closest_si


def frames_to_run(mode: RendererType, accum_id: int, n_frames: int) -> int:
    """How many of ``n_frames`` requested frames a call renders from a
    state with ``accum_id`` frames: all of them, but a deterministic mode
    converges in one frame, so it renders at most one per accumulation."""
    n = max(n_frames, 0)
    return min(n, int(accum_id == 0)) if mode in DETERMINISTIC_MODES else n


def _bakes(bvh: BVH) -> bool:
    """Does a Renderer of this BVH bake the shared-origin table?  On the
    cluster tier on a CUDA device only."""
    return bvh.clustered and bvh.tri_tab.device.type == "cuda"


def render_tile(camera: Camera, accum_id: int, ds: DeviceScene, bvh: BVH, *,
                mode: RendererType, width: int, height: int, path_depth: int, ratio_samples: int,
                baked_tab: BakedTable | None = None, row_offset: int = 0, rows: int | None = None,
                plain: bool = False):
    """Render the tile of ``rows`` image rows (default: all ``height``)
    starting at ``row_offset`` of the width x height frame (JAX
    renderer.py:43-57): one tile is the whole frame on one device, and a row
    shard of it in the multi-device split (``parallel.sharding``).  Pixel
    ids, and so the RNG streams (deviceCode.cu:65-66), are absolute, so a
    split image is bit-identical to the whole one.  ``baked_tab``: the
    table baked for ``camera.pos``, for the primary trace.  ``accum_id``:
    an int, or a 0-d int64 tensor on the device (``frame_graph``).
    ``plain``: on the card too, the camera and RNG head, the brute tier's
    shading and the path bounce take their plain PyTorch versions instead
    of kernels K0-K3 (the trace kernels still run): the reference that
    ``chip_smoke.py`` and ``utils.profile_frames --plain`` hold the
    kernels' frames against.

    Returns (color (rows*width, 3), gbuffers (rows, width, ...), aux dict,
    live): ``live`` is RATIO's count of the lanes that hit a non-emitting
    surface (0-d int64 on the device, ``ratio_color``), None in other modes.
    """
    from ..integrators.gbuffer import gbuffer_color
    from ..integrators.ltc_direct import ltc_baseline_color
    from ..integrators.path import path_color
    from ..integrators.ratio import ratio_color

    rows = height if rows is None else rows
    n = rows * width
    bh, bw = block_dim(rows), block_dim(width)

    def unblock(a):  # block-major (n, ...) -> pixel-major
        rest = tuple(a.shape[1:])
        return a.reshape((rows // bh, width // bw, bh, bw) + rest).transpose(1, 2).reshape((n,) + rest)

    # pixel ids in block-major order: a pure permutation, so RNG streams
    # (keyed by the absolute pixel id) and the image are unchanged;
    # get_rng(accumId + 10007, pixel, dims) and the jittered rays, deviceCode.cu:65-73
    with span("frame.camera_rng"):
        rays, rstate = camera_rng(camera, accum_id, width, height, row_offset, rows, plain=plain)
    with span("frame.primary_trace"):
        si = trace_closest_si(ds, bvh, rays, baked_tab=baked_tab, plain=plain)

    aux: dict = {}
    live = None
    if mode in GBUFFER_MODES:
        with span("frame.gbuffer_color"):
            color = gbuffer_color(mode, si, ds.miss_color)
    elif mode == RendererType.LTC_BASELINE:
        with span("frame.ltc"):
            color = ltc_baseline_color(ds, rays, si)
    elif mode == RendererType.PATH:  # its stages are path_color's
        color, rstate, alive_counts = path_color(ds, bvh, rays, si, rstate, max_depth=path_depth, plain=plain)
        aux["path_alive_counts"] = alive_counts
    else:  # RendererType.RATIO: its stages are ratio_color's (frame.ratio.*)
        color, rstate, aux, live = ratio_color(ds, bvh, rays, si, rstate, n_samples=ratio_samples)

    with span("frame.gbuffers"):  # the unblock copies to pixel order: the six g-buffers, the color, RATIO's buffers
        if mode == RendererType.RATIO:
            aux = {k: unblock(v).reshape(rows, width, -1) for k, v in aux.items()}
        gb = GBuffers(
            position=unblock(si.p).reshape(rows, width, 3),
            normal=unblock(si.n_geom).reshape(rows, width, 3),
            albedo=unblock(si.diffuse).reshape(rows, width, 3),
            alpha=unblock(si.alpha).reshape(rows, width),
            uv=unblock(si.uv).reshape(rows, width, 2),
            material_id=unblock(si.material_id.to(torch.float32)).reshape(rows, width),
        )
        color = unblock(color)
    return color, gb, aux, live


def _frame_impl(state: RenderState, ds: DeviceScene, bvh: BVH, *, mode: RendererType,
                width: int, height: int, path_depth: int, ratio_samples: int,
                baked_tab: BakedTable | None = None, plain: bool = False):
    """One frame over the whole image: ``(state', gbuffers, aux)``.  The pure
    reference (JAX ``_frame_impl``): the Renderer's frames run through
    ``frame_graph.FrameSlot`` and must equal it bit for bit.  ``plain``: see
    ``render_tile``."""
    color, gb, aux, _live = render_tile(state.camera, state.accum_id, ds, bvh, mode=mode, width=width,
                                        height=height, path_depth=path_depth, ratio_samples=ratio_samples,
                                        baked_tab=baked_tab, plain=plain)
    accum = state.accum + color.reshape(height, width, 3)  # a new buffer: the input state stays as it was
    return RenderState(accum=accum, accum_id=state.accum_id + 1, camera=state.camera), gb, aux


def bvh_inputs(host: dict):
    """``(tri_verts, kw)`` of ``build_bvh(tri_verts, device, **kw)`` from the
    host geometry of ``build_device_scene``: per-triangle normals and mesh
    ids, and on the cluster tier its shade rows (JAX renderer.py:342-367).
    ``tri_attr`` is made here, before any cache lookup, so the cache key
    covers it."""
    tri_idx = host["tri_index"]
    tri_verts = host["vertices"][tri_idx]
    n_corner = host["normals"][tri_idx]  # (T, 3, 3)
    norms = n_corner.sum(axis=1)
    norms /= np.maximum(np.linalg.norm(norms, axis=-1, keepdims=True), 1e-20)
    tri_attr = None
    if len(tri_idx) > BRUTE_MAX_TRIS:
        v0 = tri_verts[:, 0]
        area = 0.5 * np.linalg.norm(np.cross(tri_verts[:, 1] - v0, tri_verts[:, 2] - v0), axis=-1)
        tri_attr = pack_attr_tab(n_corner, host["uvs"][tri_idx], host["tri_mesh"], area)
    return tri_verts, {"tri_normal": norms, "tri_mesh": host["tri_mesh"], "tri_attr": tri_attr}


class Renderer:
    """Owns the scene tensors on ``device`` and the render loop.

    ``bvh_cache_dir``: load the trace tables from, or store them into, this
    directory (``accel.build.build_bvh_cached``); None builds them."""

    def __init__(
        self,
        scene: Scene,
        width: int | None = None,
        height: int | None = None,
        mode: RendererType = RendererType.PATH,
        path_depth: int = 10,
        ratio_samples: int = 4,
        *,
        device,
        bvh_cache_dir: str | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Renderer(device={str(device)!r}) needs a CUDA device, and torch.cuda.is_available() "
                "is false; pass device='cpu' to render with the plain PyTorch trace"
            )
        self.scene = scene
        self.width = int(width or scene.img_width)
        self.height = int(height or scene.img_height)
        self.mode = RendererType(mode)
        self.path_depth = path_depth
        self.ratio_samples = ratio_samples

        self.device_scene, host = build_device_scene(scene, self.device)
        tri_verts, bvh_kw = bvh_inputs(host)
        self.bvh = build_bvh_cached(bvh_cache_dir, tri_verts, self.device, **bvh_kw)

        # state, mode and baked table change together under this lock, so a
        # snapshot of them (render_step_detached) never mixes two cameras
        self._lock = threading.Lock()
        self.state: RenderState = None  # set by set_camera
        self._baked_tab: BakedTable | None = None  # the primaries' shared-origin table (_table_for)
        # the slots (buffers and graphs) of the current _frame_key and layout: the whole frame, or
        # parallel.sharding.render_rows's tiles; one layout, so one set of graphs, at a time (_layout)
        self._frames: FrameSlots | None = None
        self.gbuffers: GBuffers | None = None
        self.aux: dict = {}
        # honest ray accounting: primary rays + the NEE and bounce rays the
        # integrator traced.  Per-bounce counts stay on the device until
        # ``metrics`` is read, so the render loop never syncs for them.
        self._metrics: dict = {"frames": 0, "rays_traced": 0, "seconds": 0.0, "alive_per_bounce": []}
        self._pending_counts: list[tuple] = []  # (sum over frames, last frame's) per-bounce counts
        self._pending_live: list[tuple] = []  # RATIO: (live lanes summed over a call's frames, its frames)
        self.set_camera(scene.cameras[0])

    def _zero_accum(self) -> torch.Tensor:
        return torch.zeros((self.height, self.width, 3), dtype=torch.float32, device=self.device)

    @property
    def baked_tab(self) -> BakedTable | None:
        """The table the primary trace takes, baked for the camera's origin;
        None off the card or off the cluster tier."""
        return self._baked_tab

    def _table_for(self, origin) -> BakedTable | None:
        """The table for the camera at ``origin`` (host (3,)): the current
        one when it has that origin (the bake enqueues one pass over the
        table, which a set_camera that keeps the position must not put into
        the next frame), else a new bake; None where the Renderer does not
        bake."""
        if not _bakes(self.bvh):
            return None
        origin = np.asarray(origin, np.float32).reshape(3)
        if self._baked_tab is not None and np.array_equal(self._baked_tab.origin, origin):
            return self._baked_tab
        with span("set_camera.bake"):
            return bake_shared_origin_tab(self.bvh.tri_tab, origin)

    def _publish(self, state: RenderState, baked_tab: BakedTable | None, mode: RendererType | None = None) -> None:
        with self._lock:
            self.state = state
            self._baked_tab = baked_tab
            if mode is not None:
                self.mode = mode
            if self._frames is not None and self._frames.key != self._frame_key():
                self._frames = None  # its graphs captured another mode

    def _frame_key(self) -> tuple:
        """What a captured frame fixes: mode, shape, which scene and BVH it
        reads, and whether its primaries take a baked table (the table
        itself is an input of the buffers: a camera move keeps the key)."""
        return (self.mode, self.width, self.height, self.path_depth, self.ratio_samples,
                id(self.device_scene), id(self.bvh), self._baked_tab is not None)

    def _layout(self, devices: list | None = None, replicas=None) -> FrameSlots:
        """The slots of the current key (under ``_lock``) over ``devices``:
        None, the whole frame on the Renderer's device; a list, one row
        tile a device (``parallel.sharding.render_rows``), whose scenes and
        BVHs ``replicas()`` makes.  Another key or layout replaces them and
        drops every slot and graph the Renderer held: it keeps one set."""
        key = self._frame_key()
        rows = None if devices is None else self.height // len(devices)
        devices = [self.device] if devices is None else list(devices)
        frames = self._frames
        if frames is None or frames.key != key or frames.devices != devices or frames.rows != rows:
            frames = self._frames = None  # the old graphs go before the new buffers
            inputs = ([self.device_scene], [self.bvh]) if rows is None else replicas()
            self._frames = FrameSlots(key, devices, rows, inputs=inputs, mode=self.mode, width=self.width,
                                      height=self.height, path_depth=self.path_depth,
                                      ratio_samples=self.ratio_samples)
        return self._frames

    def _slot(self) -> FrameSlot:
        """The whole frame's slot of the current key (under ``_lock``)."""
        return self._layout().slot(0, self.device_scene, self.bvh, self._baked_tab)

    def _snapshot(self) -> tuple:
        """One step of (state, mode, baked table, the slot of their key)."""
        with self._lock:
            return self.state, self.mode, self._baked_tab, self._slot()

    def set_mode(self, mode: RendererType) -> None:
        """Switch renderer mode and restart accumulation (the baked table
        stays: the camera did not move)."""
        mode = RendererType(mode)
        if mode == self.mode:
            return
        self._publish(RenderState(accum=self._zero_accum(), accum_id=0, camera=self.state.camera),
                      self._baked_tab, mode)

    def set_camera(self, cam: SceneCamera) -> None:
        """Reset accumulation and rebuild the basis (viewer.hpp:621-657)."""
        with span("renderer.set_camera"):
            with span("set_camera.basis"):
                device_cam = cameralib.camera_from_lookat(
                    cam.from_, cam.at, cam.up, cam.cos_fovy, self.width, self.height, self.device)
            with span("set_camera.zero"):
                accum = self._zero_accum()
            self._publish(RenderState(accum=accum, accum_id=0, camera=device_cam), self._table_for(cam.from_))

    def render(self, n_frames: int = 1) -> None:
        """Advance progressive accumulation by ``n_frames`` frames (JAX
        renderer.py:438-487): on a card n replays of the key's captured
        frame (the key's first frame ever runs eagerly, before the
        capture), on the CPU n eager ``frames_step`` calls; a deterministic
        mode renders one frame per accumulation.  Publishes clones: the
        state, the last frame's g-buffers, ``aux`` (RATIO: the mean over
        this call's frames; PATH: the last frame's per-bounce counts)."""
        t0 = time.perf_counter()
        with span("renderer.render"):
            state, mode, baked_tab, slot = self._snapshot()
            n = frames_to_run(mode, state.accum_id, n_frames)
            alive = live = None
            if n:
                state, self.gbuffers, self.aux, alive, live = slot.frames(state, baked_tab, n)
                with self._lock:
                    self.state = state
            if self.device.type == "cuda":
                with span("render.sync"):
                    torch.cuda.synchronize(self.device)  # the frames are done, not just enqueued
            self.record_frames(time.perf_counter() - t0, n,
                               None if alive is None else (alive, self.aux["path_alive_counts"]), live)

    def record_frames(self, seconds: float, count: int, alive_counts: tuple | None = None,
                      live_lanes: torch.Tensor | None = None) -> None:
        """Account ``count`` frames in ``metrics``: ``seconds`` of host time
        and, in PATH, ``alive_counts``, their per-bounce counts as (the sum
        over the frames, the last frame's), both left on the device;
        ``alive_per_bounce`` reads the last frame's.  In RATIO,
        ``live_lanes``: the frames' lanes that hit a non-emitting surface,
        summed on the device.  :meth:`render` and :meth:`commit_step` call
        it, and so does the multi-device split for frames it rendered
        itself."""
        if alive_counts is not None:
            self._pending_counts.append(alive_counts)
        if live_lanes is not None:
            self._pending_live.append((live_lanes, count))
        self._metrics["seconds"] += seconds
        self._metrics["frames"] += count
        rays = count * self.width * self.height  # primary
        if self.mode == RendererType.RATIO:
            rays *= 1 + self.ratio_samples  # and the visibility batch, those of miss and light lanes included
        self._metrics["rays_traced"] += rays

    # -- detached frames (the live viewer, JAX renderer.py:503-530) ---------
    def render_step_detached(self):
        """One frame from one snapshot of (state, mode, baked table), leaving
        the renderer as it is: ``(state', gbuffers, aux)``, clones of the
        slot's outputs (a replay of the key's graph on a card).  The caller
        adopts it with :meth:`commit_step` or drops it (a dropped frame
        changes nothing).  The work is only enqueued on a CUDA device, on
        the current stream."""
        state, _mode, baked_tab, slot = self._snapshot()
        return slot.frames(state, baked_tab, 1)[:3]

    def commit_step(self, state: RenderState, gbuffers: GBuffers, aux: dict, seconds: float) -> None:
        """Adopt a detached frame, with the accounting of one frame of
        :meth:`render` (primary and RATIO rays, the pending per-bounce
        counts)."""
        with self._lock:
            self.state = state
        self.gbuffers, self.aux = gbuffers, aux
        alive = aux.get("path_alive_counts")
        self.record_frames(seconds, 1, None if alive is None else (alive, alive))

    @property
    def metrics(self) -> dict:
        """Observability dict; drains the device-side per-bounce counts
        and, once RATIO frames are counted, RATIO's live lanes:
        ``ratio_shadow_rays``, the rays of those frames' visibility batches
        (``ratio_samples`` a pixel), and ``ratio_live_shadow_rays``, those
        of lanes that hit a non-emitting surface: exactly the rays traced,
        with a t bound above 0.  The rest are rays of miss and light lanes,
        whose visibility no buffer reads; their bound is +0, so no trace
        kernel tests them."""
        if self._pending_live:
            lanes = int(torch.stack([t for t, _n in self._pending_live]).sum())
            frames = sum(n for _t, n in self._pending_live)
            self._pending_live = []
            m = self._metrics
            m["ratio_live_shadow_rays"] = m.get("ratio_live_shadow_rays", 0) + lanes * self.ratio_samples
            traced = frames * self.width * self.height * self.ratio_samples
            m["ratio_shadow_rays"] = m.get("ratio_shadow_rays", 0) + traced
        if self._pending_counts:
            # (depth, 3) each: [alive lanes, shadow rays traced, bounce rays
            # traced] per bounce (integrators.path.path_color), summed over
            # each call's frames, then the last frame's
            counts = torch.stack([total for total, _last in self._pending_counts]
                                 + [self._pending_counts[-1][1]]).cpu().numpy()
            self._pending_counts = []
            self._metrics["alive_per_bounce"] = [int(a) for a in counts[-1][:, 0]]
            self._metrics["rays_traced"] += int(counts[:-1, :, 1:].sum())
        secs = self._metrics["seconds"]
        self._metrics["mrays_per_sec"] = self._metrics["rays_traced"] / secs / 1e6 if secs else 0.0
        return self._metrics

    def image(self) -> np.ndarray:
        """Displayed image: accum / frame count (deviceCode.cu:172)."""
        with span("renderer.image"):
            with span("image.divide"):
                img = self.state.accum / max(self.state.accum_id, 1)
            with span("image.to_host"):
                return img.cpu().numpy()

    def frame_stages(self) -> dict | None:
        """The stage map of the current key's frame graph
        (``FrameGraph.stages``: which ``frame.*`` span made each operation
        a replay runs, and where the hand kernels are); None before the
        key's capture, off the card, and while the frame is split in rows."""
        with self._lock:
            frames = self._frames
            slot = frames.slots[0] if frames is not None and frames.rows is None else None
            return None if slot is None or slot.graph is None else slot.graph.stages

    # -- checkpoint / resume: the JAX package's .npz keys -------------------
    def save_checkpoint(self, path: str) -> None:
        cam = self.state.camera
        np.savez(
            path,
            accum=self.state.accum.cpu().numpy(),
            accum_id=self.state.accum_id,
            cam_pos=cam.pos.cpu().numpy(),
            cam_dir_00=cam.dir_00.cpu().numpy(),
            cam_dir_du=cam.dir_du.cpu().numpy(),
            cam_dir_dv=cam.dir_dv.cpu().numpy(),
        )

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            arrs = {k: np.asarray(z[k], np.float32) for k in
                    ("accum", "cam_pos", "cam_dir_00", "cam_dir_du", "cam_dir_dv")}
            accum_id = int(z["accum_id"])
        if arrs["accum"].shape != (self.height, self.width, 3):
            raise ValueError(
                f"checkpoint accumulates a {arrs['accum'].shape} image; this renderer is "
                f"({self.height}, {self.width}, 3)")

        def f32(key):
            return torch.as_tensor(arrs[key], device=self.device)

        state = RenderState(
            accum=f32("accum"),
            accum_id=accum_id,
            camera=Camera(pos=f32("cam_pos"), dir_00=f32("cam_dir_00"),
                          dir_du=f32("cam_dir_du"), dir_dv=f32("cam_dir_dv")),
        )
        self._publish(state, self._table_for(arrs["cam_pos"]))  # the resumed camera's primaries
