"""Render orchestration: camera, shading stage, renderer, CLI.

``RendererType`` is the JAX package's host-only enum, re-exported here.
"""

from optix_renderer_tpu.engine.modes import RendererType

__all__ = ["RendererType"]
