"""JSON scene configuration.

Same schema the reference consumes (``src/scene.cpp:20-101``): ``spp``,
``width``, ``height``, ``renderers[]`` (ints), ``cameras[]`` with
``from/to/up/cos_fovy``, ``surface_geometry`` (OBJ path), ``area_lights``
(OBJ path).  Unlike the reference (which parses then hardcodes over these,
SURVEY.md §2.9 quirk 13), every field is honored.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .obj_loader import Model, load_obj


@dataclasses.dataclass
class SceneCamera:
    """include/scene.h:8-14."""

    from_: np.ndarray  # (3,)
    at: np.ndarray  # (3,)
    up: np.ndarray  # (3,)
    cos_fovy: float


@dataclasses.dataclass
class Scene:
    """Host scene: include/scene.h:16-34 equivalent."""

    model: Model
    tri_lights: Model
    renderers: list[int]
    cameras: list[SceneCamera]
    spp: int = 1
    img_width: int = 1024
    img_height: int = 1024
    json_path: str = ""

    def sync_lights(self) -> None:
        """Append light meshes to the main model with isLight=true and
        materialID=0 (src/scene.cpp:5-13)."""
        for light in self.tri_lights.meshes:
            light.is_light = True
            light.material_id = 0
            self.model.meshes.append(light)


def parse_scene(scene_file: str) -> Scene:
    """Load a scene JSON (src/scene.cpp:20-101). Raises on missing sections."""
    with open(scene_file, "r") as f:
        cfg = json.load(f)

    base = os.path.dirname(os.path.abspath(scene_file))

    def respath(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(base, p)

    cameras = [
        SceneCamera(
            from_=np.asarray(c["from"], np.float32),
            at=np.asarray(c["to"], np.float32),
            up=np.asarray(c["up"], np.float32),
            cos_fovy=float(c["cos_fovy"]),
        )
        for c in cfg["cameras"]
    ]
    if not cameras:
        raise ValueError("No cameras defined.")

    renderers = [int(r) for r in cfg.get("renderers", [])]

    scene = Scene(
        model=load_obj(respath(cfg["surface_geometry"])),
        tri_lights=load_obj(respath(cfg["area_lights"])),
        renderers=renderers,
        cameras=cameras,
        spp=int(cfg.get("spp", 1)),
        img_width=int(cfg.get("width", 1024)),
        img_height=int(cfg.get("height", 1024)),
        json_path=scene_file,
    )
    scene.sync_lights()
    return scene
