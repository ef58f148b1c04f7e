"""Pure interactive-state stepping: the reference's per-frame input handling
(/root/reference/Render.cpp:89-209) as a functional update.

The reference mutates globals from GLUT key callbacks; here the whole
interaction surface is `step(sim, keys, frame_ms)` -> new sim state, which
makes any frame reproducible from (scene file, key timeline) -- the
checkpoint/resume story the reference lacks (SURVEY.md section 5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..render import FrameState

KEY_W, KEY_A, KEY_S, KEY_D, KEY_Q, KEY_E, KEY_R, KEY_SPACE, KEY_I = range(9)

_KEY_DIRS = np.array(
    [
        [0, 0, 1],   # w: forward
        [-1, 0, 0],  # a: left
        [0, 0, -1],  # s: back
        [1, 0, 0],   # d: right
        [0, -1, 0],  # q: down
        [0, 1, 0],   # e: up
    ],
    np.float32,
)


class SimState(NamedTuple):
    """FrameState plus the host-side toggles (pause, interval, key edges)."""

    frame: FrameState
    paused: bool = True  # scenes start paused (Render.cpp:12)
    interval: int = -1
    prev_space: bool = False
    prev_i: bool = False

    @staticmethod
    def initial(default_interval: int = -1) -> "SimState":
        return SimState(frame=FrameState.initial(), interval=int(default_interval))


def add_velocity_np(v1, v2):
    """Host-side relativistic velocity composition: the same closed form as
    ops.relmath.add_velocity (/root/reference/Vector.cpp:189-193), in numpy
    float32. The interactive loop runs this every frame; doing it eagerly on
    the device would cost one dispatch and one fetch PER OP, for math on two
    3-vectors. tests/test_viewer.py pins equality with the jnp
    implementation."""
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    one = np.float32(1.0)
    gamma = one / np.float32(np.sqrt(one - np.float32(v1 @ v1)))
    coef = gamma / (one + gamma)
    num = v1 + v2 + coef * np.cross(v1, np.cross(v1, v2)).astype(np.float32)
    return (num / (one + np.float32(v2 @ v1))).astype(np.float32)


def step(sim: SimState, keys, frame_ms: float) -> SimState:
    """Advance one frame: velocity controls, pause/interval toggles, time.

    keys: 9 bools indexed by KEY_*; frame_ms: wall ms since last frame.
    Velocity increments are tanh(frame_ms/5000) * direction, composed
    relativistically (Render.cpp:149-176); space/i act on key-down edges
    (Render.cpp:125-147); scene time advances by frame_ms/1000 when unpaused
    (Render.cpp:177). All math is host-side numpy: the resulting FrameState
    is the jitted renderer's (tiny) traced input, and nothing here should
    touch the device.
    """
    keys = [bool(k) for k in keys]
    paused = sim.paused
    interval = sim.interval
    if keys[KEY_SPACE] and not sim.prev_space:
        paused = not paused
    if keys[KEY_I] and not sim.prev_i:
        interval = -(0 if interval else 1)  # toggles 0 <-> -1

    vel = np.asarray(sim.frame.cam_velocity, np.float32)
    if keys[KEY_R]:
        vel = np.zeros(3, np.float32)
    else:
        dv = np.zeros(3, np.float32)
        for k in range(6):
            if keys[k]:
                dv += _KEY_DIRS[k]
        if np.linalg.norm(dv) != 0:
            dv = np.tanh(frame_ms / 5000.0) * dv / np.linalg.norm(dv)
            vel = add_velocity_np(vel, dv.astype(np.float32))

    pos = np.asarray(sim.frame.cam_pos, np.float32)
    if not paused:
        pos = pos + np.array([frame_ms / 1000.0, 0, 0, 0], np.float32)

    return SimState(
        frame=FrameState(cam_velocity=vel, cam_pos=pos),
        paused=paused,
        interval=interval,
        prev_space=keys[KEY_SPACE],
        prev_i=keys[KEY_I],
    )
