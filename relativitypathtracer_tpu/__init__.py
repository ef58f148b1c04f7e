"""relativitypathtracer_tpu: a special-relativity ray tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
taylor-santos/RelativityPathTracer (reference mounted at /root/reference):
per-object inertial rest frames, Lorentz-boosted 4D rays traced along the past
light cone, analytic sphere/cube primitives, OBJ meshes with an octree
acceleration structure, retarded-time lighting and shadows, proper-time
flashes, and Hable tonemapping -- as a batched wavefront renderer where one
frame is one jitted call.
"""

from .models.dsl import load_scene_file, parse_scene
from .models.scene import build_scene
from .render import FrameState, build_render_fn, render_frame

__all__ = [
    "load_scene_file",
    "parse_scene",
    "build_scene",
    "FrameState",
    "build_render_fn",
    "render_frame",
]

__version__ = "0.5.0"
