"""Renderer modes — same ids as the reference enum (common.cuh:17-29)."""

from __future__ import annotations

import enum


class RendererType(enum.IntEnum):
    DIFFUSE = 0
    ALPHA = 1
    NORMALS = 2
    SHADE_NORMALS = 3
    POSITION = 4
    MASK = 5
    MATERIAL_ID = 6
    LTC_BASELINE = 7
    RATIO = 8
    PATH = 9


# common.cuh:31-42 (with the missing-comma label bug fixed, SURVEY §2.9 #11)
RENDERER_NAMES = [
    "Diffuse",
    "Alpha",
    "Normals",
    "Shading Normals",
    "Position",
    "Mask",
    "Material ID",
    "LTC Baseline",
    "RATIO",
    "PATH",
]

GBUFFER_MODES = (
    RendererType.DIFFUSE,
    RendererType.ALPHA,
    RendererType.NORMALS,
    RendererType.SHADE_NORMALS,
    RendererType.POSITION,
    RendererType.MASK,
    RendererType.MATERIAL_ID,
)

# Analytic modes are deterministic: accumulation is a visual no-op, so the
# renderer stops re-rendering after one frame (fixes SURVEY §2.9 quirk 12).
DETERMINISTIC_MODES = GBUFFER_MODES + (RendererType.LTC_BASELINE,)
