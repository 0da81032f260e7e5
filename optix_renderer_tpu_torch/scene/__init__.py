"""Scene: device tensors and texture sampling.

Host parsing is the JAX package's numpy-only code, re-exported here so
callers of the port need no name from ``optix_renderer_tpu``.
"""

from optix_renderer_tpu.scene.config import Scene, SceneCamera, parse_scene
from optix_renderer_tpu.scene.procedural import write_cornell_scene

__all__ = ["Scene", "SceneCamera", "parse_scene", "write_cornell_scene"]
