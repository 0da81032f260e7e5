"""Render orchestration: camera, shading stage, renderer, CLI.

``RendererType`` (``engine.modes``) is re-exported here.
"""

from .modes import RendererType

__all__ = ["RendererType"]
