"""The system under test, as the benchmark reaches it: the port's scene
types, flatten, camera and the options that `integrate.path.render`
derives from a scene. Everything else the traffic kinds call is the port's
public entry points (`render_chunk`, `material_grad_step`)."""
from __future__ import annotations

import numpy as np


def scene_and_camera(desc: dict, device):
    """The port's flattened SceneData and Camera of a plain scene
    description (`portbench/scenes/`): its meshes (normals and uvs may be
    None), their materials with any texture indices, and its textures."""
    from optixpathtracer_tpu_torch.camera import Camera
    from optixpathtracer_tpu_torch.scene import (Material, Mesh, Model,
                                                 PointLight, Texture,
                                                 flatten_model)
    meshes = [Mesh(positions=m["positions"], indices=m["indices"],
                   normals=m.get("normals"), uvs=m.get("uvs"),
                   material=Material(**m["material"]))
              for m in desc["meshes"]]
    textures = [Texture(pixels=np.asarray(t, np.float32))
                for t in desc.get("textures") or []]
    lights = [PointLight(np.asarray(p), np.asarray(c))
              for p, c in desc["lights"]]
    cam = desc["camera"]
    camera = Camera(position=np.asarray(cam["position"], np.float64),
                    rotation=np.asarray(cam["rotation"], np.float64),
                    fov_degrees=float(cam["fov_degrees"]))
    model = Model(meshes=meshes, textures=textures)
    return flatten_model(model, lights, device=device), camera


def render_options(scene) -> dict:
    """The keyword options `render` hands `render_chunk` for this scene."""
    from optixpathtracer_tpu_torch.integrate.cutout import \
        scene_uses_alpha_cutout
    from optixpathtracer_tpu_torch.scene.flatten import (scene_active_lobes,
                                                         scene_flat_shading,
                                                         scene_uses_textures)
    return dict(active_lobes=scene_active_lobes(scene),
                use_textures=scene_uses_textures(scene),
                use_alpha_cutout=scene_uses_alpha_cutout(scene),
                flat_shading=scene_flat_shading(scene))
