"""Launch counts of the hand-written kernels, right across CUDA graphs.

Each kernel wrapper counts its launches in its module's ``LAUNCHES`` dict
through ``count_launch``, so that a run can show which kernels its main
path went through.  A launch that a CUDA graph's capture records
(``engine.frame_graph``) runs nothing then, and runs again at every
replay.  So while ``recording`` is open on a thread, that thread's
launches go into its tally instead of the counts, and the graph adds the
tally at every replay (``add``): a count always means kernels that ran.
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()  # .tally: the open recording's list of (counts, name), or None


def count_launch(counts: dict, name: str) -> None:
    """One launch of kernel ``name``: into ``counts``, or into the tally of
    the recording open on this thread."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        counts[name] += 1
    else:
        tally.append((counts, name))


@contextlib.contextmanager
def recording():
    """Collect this thread's launches as a list of (counts, name) instead
    of counting them; yields the list."""
    if getattr(_local, "tally", None) is not None:
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
