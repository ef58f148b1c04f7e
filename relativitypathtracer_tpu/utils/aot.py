"""Ahead-of-time export of the frame renderer as a portable artifact.

`jax.export` serializes the traced-and-lowered frame step (StableHLO +
calling convention) so a serving host can run frames WITHOUT the Python
scene pipeline: deserialize, then call with (scene pytree, FrameState).
The scene stays an ARGUMENT, so one artifact serves any scene whose build
produces the same array shapes (same object counts / texture atlas / mesh
pools) -- shape-polymorphic serving of scene edits, camera motion and
boosts with zero retracing.

The reference has no analog (it JIT-compiles OpenCL at every startup,
/root/reference/CLSetup.cpp); this is the deployment story here: export
once on any host (cross-platform lowering needs no card, Triton kernels
included), ship the artifact to the serving hosts, `load_render` and go.
"""

from __future__ import annotations

import jax
from jax import export as jax_export

from ..models.scene import MeshArrays, MeshStatic, ObjectsSoA, Scene
from ..render import FrameState, build_render_fn

# The artifact's calling convention includes the argument PyTreeDefs;
# every NamedTuple node in (Scene, FrameState) must be registered for
# serialization. Serialized names are a compatibility contract: keep them
# stable even if the classes move modules.
for _t in (ObjectsSoA, MeshArrays, MeshStatic, Scene, FrameState):
    try:
        jax_export.register_namedtuple_serialization(
            _t, serialized_name=f"rpt.{_t.__name__}")
    except ValueError:  # already registered (re-import, tests)
        pass


# The Triton mesh walks lower to this custom call. It carries the kernel's
# Triton IR, which has no cross-version compatibility guarantee: an artifact
# holding it must be served by the jax/jaxlib version that exported it.
_TRITON_CALL = "__gpu$xla.gpu.triton"
_CHECKS = [jax_export.DisabledSafetyCheck.custom_call(_TRITON_CALL)]


def _arg_structs(scene):
    """ShapeDtypeStructs for (scene, state) matching a built Scene pytree."""
    scene_s = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), scene)
    state_s = FrameState(
        cam_velocity=jax.ShapeDtypeStruct((3,), "float32"),
        cam_pos=jax.ShapeDtypeStruct((4,), "float32"))
    return scene_s, state_s


def export_render(scene, meta, width: int, height: int,
                  interval: int | None = None, msaa: int = 1,
                  platforms: tuple[str, ...] = ("cuda",)) -> bytes:
    """Serialize the jitted frame renderer for the given platforms.

    `scene` supplies only the input SHAPES (it is not baked in). Platforms
    are lowered eagerly on this host -- no device of that kind is needed
    ("cuda" exports fine from a CPU box, Triton kernels included; the jnp
    scan route also lowers for "cpu"). The mesh-walk route is the one
    resolve_kernels picks while tracing (PALLAS_MODE to force it)."""
    if interval is None:
        interval = meta.default_interval
    fn = build_render_fn(meta, width, height, int(interval), msaa)
    scene_s, state_s = _arg_structs(scene)
    exp = jax_export.export(jax.jit(fn), platforms=platforms,
                            disabled_checks=_CHECKS)(scene_s, state_s)
    return bytes(exp.serialize())


def export_sharded_render(scene, meta, width: int, height: int, mesh,
                          interval: int | None = None, msaa: int = 1,
                          platforms: tuple[str, ...] = ("cuda",)) -> bytes:
    """Serialize the MULTI-DEVICE renderer (parallel/tiles.py shard_map over
    `mesh`). The artifact records the device count; the serving host calls
    it with arguments device_put onto an equal-size mesh (replicated
    PartitionSpec() -- the scene is replicated, the image decomposition is
    internal)."""
    from ..parallel.tiles import build_sharded_render_fn

    if interval is None:
        interval = meta.default_interval
    fn = build_sharded_render_fn(meta, width, height, int(interval), mesh,
                                 msaa=msaa)
    scene_s, state_s = _arg_structs(scene)
    exp = jax_export.export(jax.jit(fn), platforms=platforms,
                            disabled_checks=_CHECKS)(scene_s, state_s)
    return bytes(exp.serialize())


def load_render(data: bytes):
    """Deserialize an exported renderer; returns render(scene, state) ->
    (H, W, 3) image, executable on any platform the artifact was exported
    for (device dispatch is the caller's jax context; multi-device artifacts
    need args device_put onto a mesh of the exported size)."""
    exp = jax_export.deserialize(data)
    return exp.call
