"""Scene: device tensors and texture sampling.

Host parsing (``config``, ``obj_loader``) and the procedural scenes are
numpy-only; their names are re-exported here.
"""

from .config import Scene, SceneCamera, parse_scene
from .procedural import (write_cornell3_scene, write_cornell_scene, write_gallery_scene, write_spd_tetra_scene,
                         write_terrain_scene)

__all__ = ["Scene", "SceneCamera", "parse_scene", "write_cornell3_scene", "write_cornell_scene", "write_gallery_scene",
           "write_spd_tetra_scene", "write_terrain_scene"]
