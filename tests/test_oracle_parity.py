"""Differential tests: JAX renderer vs the native C++ oracle.

The oracle (native/cpu_reference.cpp) independently implements the full
reference algorithm including the stackless octree walk; the JAX renderer on
the CPU uses the factored brute-force jnp mesh scan. Agreement across all 8
scenes cross-validates both. Tolerance: every pixel within 1e-3 except a
small fraction of contrast-edge pixels where fp rounding flips a hit/miss or
bilinear-tap decision (inevitable between any two float implementations).
"""

import pathlib
import subprocess

import numpy as np
import pytest

from relativitypathtracer_tpu import FrameState, build_scene, load_scene_file, render_frame
from relativitypathtracer_tpu.utils.scene_blob import write_scene_blob

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 192, 108

SCENES = ["cube", "soccer", "arch", "cubes", "ladder_paradox", "rulers", "shadows", "bunny"]
# scene -> max fraction of pixels allowed above 1e-3
TOL = {name: 0.005 for name in SCENES}

# the `oracle` fixture (locate + build the C++ oracle) lives in conftest.py


@pytest.mark.parametrize("name", SCENES)
def test_scene_matches_oracle(name, oracle, reference_root, tmp_path):
    host = load_scene_file(str(reference_root / "Scenes" / f"{name}.txt"))
    scene, meta = build_scene(host)
    state = FrameState.initial()

    blob = tmp_path / f"{name}.blob"
    out = tmp_path / f"{name}.rgb"
    write_scene_blob(str(blob), scene, meta, state, W, H)
    subprocess.run([oracle, str(blob), str(out)], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(H, W, 3)

    ours = np.asarray(render_frame(scene, meta, state, W, H))
    diff = np.abs(ref - ours)
    frac_bad = float(np.mean(diff.max(-1) > 1e-3))
    assert diff.mean() < 1e-3, f"mean diff {diff.mean()} too high"
    assert frac_bad <= TOL[name], f"{frac_bad * 100:.2f}% pixels differ > 1e-3"


def test_oracle_parity_at_nonzero_time_and_velocity(oracle, reference_root, tmp_path):
    """Moving camera + advanced scene time exercises the full boost chain."""
    import jax.numpy as jnp

    host = load_scene_file(str(reference_root / "Scenes" / "rulers.txt"))
    scene, meta = build_scene(host)
    state = FrameState(
        cam_velocity=jnp.array([0.3, 0.1, -0.2], jnp.float32),
        cam_pos=jnp.array([2.5, 0, 0, 0], jnp.float32),
    )
    blob = tmp_path / "rulers_t.blob"
    out = tmp_path / "rulers_t.rgb"
    write_scene_blob(str(blob), scene, meta, state, W, H, interval=-1)
    subprocess.run([oracle, str(blob), str(out)], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(H, W, 3)
    ours = np.asarray(render_frame(scene, meta, state, W, H, interval=-1))
    diff = np.abs(ref - ours)
    assert diff.mean() < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.01


def test_multi_mesh_scene(oracle, reference_root, tmp_path):
    """Two meshes sharing the global pool: the reference's octree roots are
    seeded with ALL triangles but SAT-cull foreign ones during subdivision
    (SURVEY.md 3.4); our reachable-set must reproduce that (mesh 2's
    instance must NOT render mesh 1's geometry)."""
    from conftest import MULTI_SCENE as text

    from relativitypathtracer_tpu import build_scene, parse_scene

    host = parse_scene(text, str(reference_root))
    scene, meta = build_scene(host)
    assert len(meta.mesh_ids) == 2
    # Reachable sets follow the reference quirk exactly: the triangle sits
    # inside the pear's root bounds, so the pear's octree keeps it (2848+1);
    # no pear triangle survives the triangle's flat root box.
    assert len(meta.mesh_perms[0]) == 1
    assert len(meta.mesh_perms[1]) == 2849

    state = FrameState.initial()
    blob = tmp_path / "mm.blob"
    out = tmp_path / "mm.rgb"
    write_scene_blob(str(blob), scene, meta, state, W, H)
    subprocess.run([oracle, str(blob), str(out)], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(H, W, 3)
    ours = np.asarray(render_frame(scene, meta, state, W, H))
    diff = np.abs(ref - ours)
    assert diff.mean() < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.01


def test_disjoint_two_mesh_scene(oracle, tmp_path):
    """Two meshes with DISJOINT bounds: mesh B's root is seeded with the whole
    shared pool but its octree-reachable set excludes A's triangle, so
    len(perm) != seeded-range length. Regression: MeshStatic sizing used the
    seeded length, crashing build_scene with a reshape error for exactly this
    shape of scene."""
    (tmp_path / "a.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "b.obj").write_text(
        "v 100 100 100\nv 101 100 100\nv 100 101 100\nf 1 2 3\n")
    text = """Ma.obj
Mb.obj
Om0
 p-1,0,5,0,0,1,0,1,1,1
 c0.9,0.2,0.2
Om1
 p101,-100,-95,0,0,1,0,1,1,1
 c0.2,0.9,0.2
A1
R
"""
    from relativitypathtracer_tpu import parse_scene

    host = parse_scene(text, str(tmp_path))
    scene, meta = build_scene(host)  # used to crash here
    assert len(meta.mesh_ids) == 2
    assert len(meta.mesh_perms[1]) == 1  # B's reachable set excludes A's tri
    # Static kernel inputs sized by the ACTUAL row count (padded to 256).
    assert scene.mesh_static[1].gen_rows.shape[1] == 256
    assert scene.mesh_static[1].spheres.shape[0] == 256 // 32

    state = FrameState.initial()
    blob = tmp_path / "dj.blob"
    out = tmp_path / "dj.rgb"
    write_scene_blob(str(blob), scene, meta, state, W, H)
    subprocess.run([oracle, str(blob), str(out)], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(H, W, 3)
    ours = np.asarray(render_frame(scene, meta, state, W, H))
    diff = np.abs(ref - ours)
    assert diff.mean() < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.01


@pytest.mark.parametrize("seed", [0, 3])
def test_flagship_matches_oracle(seed, oracle, tmp_path):
    """The in-repository flagship scene (utils.demo_scenes: non-convex
    5,120-triangle mesh with self-shadowing, moving retarded-time light,
    textured flashing cube) against the oracle at a small size."""
    from relativitypathtracer_tpu.utils.demo_scenes import flagship_scene

    scene, meta = flagship_scene(seed)
    state = FrameState.initial()
    blob = tmp_path / "flag.blob"
    out = tmp_path / "flag.rgb"
    write_scene_blob(str(blob), scene, meta, state, W, H)
    subprocess.run([oracle, str(blob), str(out)], check=True, capture_output=True)
    ref = np.fromfile(out, np.float32).reshape(H, W, 3)
    ours = np.asarray(render_frame(scene, meta, state, W, H))
    diff = np.abs(ref - ours)
    assert (ours.max(-1) > 0.3).mean() > 0.05, "flagship frame mostly empty"
    assert diff.mean() < 1e-3
    assert float(np.mean(diff.max(-1) > 1e-3)) <= 0.002
