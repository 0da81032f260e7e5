"""Tonemapping — gamma curve used by the reference's offline script
(``save_images.py:12-17``: pow(1/2.2), clip to [0,1])."""

from __future__ import annotations

import numpy as np


def gamma(img: np.ndarray, g: float = 2.2) -> np.ndarray:
    """HDR -> display: clip(x, 0, inf) ** (1/g), clipped to [0,1]."""
    return np.clip(np.maximum(img, 0.0) ** (1.0 / g), 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
