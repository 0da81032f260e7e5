"""The port's one instrumentation module: launch counts of the
hand-written kernels right across CUDA graphs, the program's spans, and
the stage map of a captured frame graph, and the work records of the
kernels that count their own work.

Each kernel wrapper counts its launches in its module's ``LAUNCHES`` dict
through ``count_launch``, so that a run can show which kernels its main
path went through.  A launch that a CUDA graph's capture records
(``engine.frame_graph``) runs nothing then, and runs again at every
replay.  So while ``recording`` is open on a thread, that thread's
launches go into its tally instead of the counts, and the graph adds the
tally at every replay (``add``): a count always means kernels that ran.

``span(name)`` marks a piece of the program's host work.  With no
profiler session open it is a shared null context behind one check; with
one open it is ``torch.profiler.record_function(name)``, so the spans land
in the same trace as the device's operations, on one clock.  Every name
has a dotted prefix (``renderer.``, ``frame_graph.``, ``frame.``,
``trace.``, ``bounce.``, ...); none is a bare ``set_camera``, ``render``
or ``readback``.

A replayed graph runs no Python, so its kernels carry no span.  While a
graph is captured (``stage_map``), each ``frame.*`` span records instead
how many executable nodes (kernels, memsets, memcpys) the graph under
capture holds when it is entered and when it exits, and each hand-kernel
launch the position of the node it made.  The result names the stage of
every node of the graph by its position: the ``i``-th operation a replay
runs on the card is node ``i``.  The cluster tier's ``trace.*`` spans
(sweep, sort, fused shading) are recorded the same way, as stages
nested in the ``frame.*`` stage around them.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

STAGE_PREFIX = "frame."  # the spans a stage map records as stages
NESTED_PREFIX = "trace."  # and as stages nested in them
_NULL = contextlib.nullcontext()


class _Local(threading.local):
    tally = None  # the open recording's list of (counts, name)
    stages = None  # the open stage map (_StageMap)
    work = None  # the open work_records list


_local = _Local()


def count_launch(counts: dict, name: str, kernel: str | None = None) -> None:
    """One launch of ``name``: into ``counts``, or into the tally of the
    recording open on this thread.  ``kernel``: the ``__global__`` function
    it launched, which an open stage map puts at the launch's node."""
    tally = _local.tally
    if tally is None:
        counts[name] += 1
        return
    tally.append((counts, name))
    if _local.stages is not None:
        _local.stages.launched(kernel or name)


@contextlib.contextmanager
def recording():
    """Collect this thread's launches as a list of (counts, name) instead
    of counting them; yields the list."""
    if _local.tally is not None:
        raise RuntimeError("a launch recording is already open on this thread")
    _local.tally = tally = []
    try:
        yield tally
    finally:
        _local.tally = None


def add(tally: list) -> None:
    """Count once more every launch of a recording (one replay of it)."""
    for counts, name in tally:
        counts[name] += 1


@contextlib.contextmanager
def work_records():
    """Have the kernels that keep their own work counters (the cluster
    tier's walks, ``accel.cluster_trace``) count at every launch on this
    thread that gives no counter of its own; yields the list to which each
    such launch appends (name, work (4,) int64, scene boxes, rays and
    results).  Not for a graph capture: a counter is a new tensor."""
    if _local.work is not None:
        raise RuntimeError("work records are already open on this thread")
    _local.work = records = []
    try:
        yield records
    finally:
        _local.work = None


def open_work_records():
    """The list of the ``work_records`` open on this thread, or None."""
    return _local.work


def span(name: str):
    """A context over a piece of the program's host work named ``name``:
    a profiler range while a profiler session is open, a boundary of the
    stage map being captured on this thread for a ``frame.*`` or
    ``trace.*`` name, else nothing at all."""
    stages = _local.stages
    if stages is not None and name.startswith((STAGE_PREFIX, NESTED_PREFIX)):
        return stages.span(name)
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


class _StageMap:
    """The bookkeeping of one capture: the stack of open ``frame.*`` and
    ``trace.*`` spans under ``root``, the nodes each owns, the hand
    kernels' nodes."""

    def __init__(self, count_nodes, root: str):
        self.count_nodes = count_nodes
        self.open = [root]
        self.stages: list[list] = []  # [stage, first node, end node), in order
        self.nested: list[list] = []  # [trace stage, first node, end node), each inside one stage entry
        self.kernels: list[list] = []  # [node, kernel]
        self.nodes = 0  # nodes owned so far

    def cut(self) -> None:
        """The nodes made since the last boundary go to the innermost open
        ``frame.*`` span (or the root), and to the innermost ``trace.*``
        span opened inside it, if any."""
        n = self.count_nodes()
        if n <= self.nodes:
            return
        at = next(i for i in range(len(self.open) - 1, -1, -1)
                  if i == 0 or self.open[i].startswith(STAGE_PREFIX))
        stage = self.open[at]
        if self.stages and self.stages[-1][0] == stage:
            self.stages[-1][2] = n
        else:
            self.stages.append([stage, self.nodes, n])
        if at < len(self.open) - 1:
            inner = self.open[-1]
            last = self.nested[-1] if self.nested else None
            if last is not None and last[0] == inner and last[2] == self.nodes and last[1] >= self.stages[-1][1]:
                last[2] = n
            else:
                self.nested.append([inner, self.nodes, n])
        self.nodes = n

    @contextlib.contextmanager
    def span(self, name: str):
        self.cut()
        self.open.append(name)
        try:
            with torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _NULL:
                yield
        finally:
            self.cut()
            self.open.pop()

    def launched(self, kernel: str) -> None:
        self.kernels.append([self.count_nodes() - 1, kernel])

    def result(self) -> dict:
        self.cut()
        return {"nodes": self.nodes, "stages": self.stages, "nested": self.nested, "kernels": self.kernels}


@contextlib.contextmanager
def stage_map(root: str):
    """Record the stage map of the graph being captured on the current
    stream (open it inside the capture); yields a dict that holds, once
    the block is done, ``nodes`` (the graph's executable nodes),
    ``stages`` (``[stage, first, end]`` in order, covering nodes 0 to
    ``nodes`` once each; a node made outside every ``frame.*`` span goes
    to ``root``), ``nested`` (``[trace stage, first, end]`` in order: the
    nodes made inside a ``trace.*`` span, by the innermost one opened
    inside their stage; each entry lies inside one entry of ``stages``,
    and no node is in two) and ``kernels`` (``[node, kernel]`` of each
    hand-kernel launch).  The dict stays empty where no node counter is there
    (``capture_node_counter``)."""
    if _local.stages is not None:
        raise RuntimeError("a stage map is already open on this thread")
    out: dict = {}
    count = capture_node_counter()
    if count is None:
        yield out
        return
    _local.stages = stages = _StageMap(count, root)
    try:
        yield out
        out.update(stages.result())
    finally:
        _local.stages = None


# libcuda's CUstreamCaptureStatus ACTIVE; its CUgraphNodeType KERNEL, MEMCPY, MEMSET
_CAPTURE_ACTIVE = 1
_EXECUTABLE = (0, 1, 2)


def capture_node_counter():
    """A function that returns how many executable nodes the graph being
    captured on the current stream holds, through the ``libcuda`` that
    PyTorch has loaded (``cuStreamGetCaptureInfo_v2``, ``cuGraphGetNodes``,
    ``cuGraphNodeGetType``; no build); None without a CUDA device or
    ``libcuda``."""
    if not torch.cuda.is_available():
        return None
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        info, get_nodes, node_type = cu.cuStreamGetCaptureInfo_v2, cu.cuGraphGetNodes, cu.cuGraphNodeGetType
    except (OSError, AttributeError):
        return None
    p, u64, size = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_size_t
    info.argtypes = [p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(u64), ctypes.POINTER(p),
                     ctypes.POINTER(p), ctypes.POINTER(size)]
    get_nodes.argtypes = [p, ctypes.POINTER(p), ctypes.POINTER(size)]
    node_type.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    for fn in (info, get_nodes, node_type):
        fn.restype = ctypes.c_int
    stream = p(torch.cuda.current_stream().cuda_stream)
    kinds: dict = {}  # node -> executable?  A node's type never changes

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def count() -> int:
        status, cid, graph, deps, ndeps = ctypes.c_int(), u64(), p(), p(), size()
        check(info(stream, status, cid, graph, deps, ndeps), "cuStreamGetCaptureInfo_v2")
        if status.value != _CAPTURE_ACTIVE:
            raise RuntimeError("no graph is being captured on the stream")
        n = size(0)
        check(get_nodes(graph, None, n), "cuGraphGetNodes")
        if n.value == 0:
            return 0
        nodes = (p * n.value)()
        check(get_nodes(graph, nodes, n), "cuGraphGetNodes")
        total = 0
        for node in nodes[:n.value]:
            kind = kinds.get(node)
            if kind is None:
                t = ctypes.c_int()
                check(node_type(node, t), "cuGraphNodeGetType")
                kind = kinds[node] = t.value in _EXECUTABLE
            total += kind
        return total

    return count
