"""Bytes the LTC term (kernel B6, ``csrc/ltc.cu::ltc_kernel``; its name is
``kernels.LTC``) moves at its boundary in a frame, counted from what every
correct implementation must move whatever each lane hit, so that the
share of the roofline cannot pass 100 % however the kernel is built.

* Each lane's LTC radiance out once: 3 float32 = 12 bytes.  The term is
  a buffer of one colour a pixel, which the frame adds up (RATIO's
  ``ltc``, the LTC modes' colour), so every lane's colour is written,
  a miss's and a light's too.
* Each lane's hit record in once: 4 bytes, the least that tells a lane
  whether and what it hit (the trace layer's record out,
  ``bytes.RECORD_OUT``).  A hit lane reads far more (its point, normal,
  roughness and colour, 44 bytes), but the record holds no count of hit
  lanes, so no lane is counted as one.
* The scene's lights once a frame: each triangle light's three corners
  and its emission, 12 float32 = 48 bytes.  Its normal follows from the
  corners and is not counted.

Nothing of the lookup tables (read by hit lanes alone) and no operation
count: the operations too are a hit lane's (``ltc_direct_ops``), and a
miss lane needs none.
"""

from __future__ import annotations

from .bytes import RECORD_OUT

COLOR_OUT = 12
LIGHT = 48


def ltc_bytes(frames: int, width: int, height: int, lights: int) -> int:
    return frames * (width * height * (RECORD_OUT + COLOR_OUT) + lights * LIGHT)
