"""Bytes a layer moves at its boundary, each input read once and each output
written once, counted from what the data needs and not from what a kernel
of the renderer happens to read: so a fused or re-designed kernel cannot
push its share of the roofline above 100 %.  Each count is a floor.

* Trace layer (``trace_bytes``): each traced ray in once (origin,
  direction, t_max: 7 float32 = 28 bytes) and its record out once (4
  bytes: a triangle id, or an occlusion word), rays from the renderer's
  honest count (primary rays plus the NEE and bounce rays it traced); and
  each query launch reads the scene's triangles once (3 float32 vertices
  = 36 bytes a triangle).  No operation count: no implementation-free
  floor of operations exists for a closest-hit query.
* Bounce layer (``bounce_bytes``): for every lane alive at a bounce, the
  path state in (position, normal, direction back, diffuse color,
  throughput: 5 x 12 bytes; roughness 4, the alive flag 1, the RNG state
  4: 69 bytes), the two traces' results in (occluded 1, the bounce hit's
  id and barycentrics 12: 13 bytes), the next state out (69) and the
  color out (12): 163 bytes.  Nothing between K1 and K2 is counted.
"""

from __future__ import annotations

RAY_IN, RECORD_OUT, TRIANGLE = 28, 4, 36
STATE, TRACE_RESULTS, COLOR = 69, 13, 12
BOUNCE_LANE = STATE + TRACE_RESULTS + STATE + COLOR


def trace_bytes(rays: int, query_launches: int, triangles: int) -> int:
    return rays * (RAY_IN + RECORD_OUT) + query_launches * triangles * TRIANGLE


def bounce_bytes(frames: int, alive_per_bounce) -> int:
    """``alive_per_bounce``: lanes alive at each bounce of a frame (the
    renderer's last frame stands for each)."""
    return frames * sum(int(a) for a in alive_per_bounce) * BOUNCE_LANE

