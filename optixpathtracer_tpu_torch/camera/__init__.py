"""Camera layer (port of `optixpathtracer_tpu/camera`)."""
from .camera import (Camera, blender_to_engine_position,  # noqa: F401
                     blender_to_engine_rotation, generate_rays,
                     jittered_rays, look_at, perspective)
