"""Test harness config: force the CPU backend with 8 virtual devices so unit
and sharding tests run anywhere. The platform is pinned via jax.config after
import as well as by JAX_PLATFORMS, so a GPU host runs the suite on its CPU
too; tests that need the card carry the `gpu` marker (registered in
pyproject.toml) and skip unless a GPU backend is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# RPT_TEST_PLATFORM=cuda keeps the card visible for the `gpu`-marked tests.
jax.config.update("jax_platforms", os.environ.get("RPT_TEST_PLATFORM", "cpu"))

import pathlib

import pytest

REFERENCE_ROOT = pathlib.Path(os.environ.get("REF_ASSETS", "/root/reference"))


@pytest.fixture(scope="session")
def reference_root():
    if not REFERENCE_ROOT.exists():
        pytest.skip("reference asset tree not available")
    return REFERENCE_ROOT


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (see the `gpu` marker)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA card: RPT_TEST_PLATFORM=cuda on a GPU host")


@pytest.fixture(scope="session")
def oracle():
    """Path to the built C++ differential oracle (one locate-and-build
    implementation for every suite that diffs against it)."""
    import shutil
    import subprocess

    repo = pathlib.Path(__file__).resolve().parent.parent
    binary = repo / "native" / "cpu_reference"
    if not binary.exists():
        if shutil.which("g++") is None:
            pytest.skip("no g++ available to build the oracle")
        subprocess.run(["make", "-C", str(repo / "native")], check=True,
                       capture_output=True)
    return str(binary)


# Two-mesh scene with a point light: exercises the per-mesh walk loop
# (primary + shadow). Shared by the interpret and oracle-parity suites (one
# copy: drift between copies weakens coverage).
MULTI_SCENE = """MModels/triangle.obj
MModels/pear.obj
Om0
 p-2,0,6,0,0,1,0,2,2,2
 c0.9,0.2,0.2
Om1
 p2,0,6,0,0,1,0,1,1,1
 c0.2,0.9,0.2
Os
 p0,4,4,0,0,0,0,0.2,0.2,0.2
 c1,1,1
 l1
A0.3
R
"""


def render_with_mode(scene, meta, mode, w=128, h=64, state=None):
    """Render with the mesh-walk routing forced to `mode` (False = jnp
    scan, "interpret" = the Triton kernels in interpret mode), with
    the renderer cache cleared on BOTH sides so a failure cannot leave a
    poisoned mode in build_render_fn's lru cache."""
    import numpy as np

    from relativitypathtracer_tpu import FrameState, render_frame
    from relativitypathtracer_tpu.ops import mesh_intersect
    from relativitypathtracer_tpu.render import build_render_fn

    mesh_intersect.PALLAS_MODE = mode
    build_render_fn.cache_clear()  # cached renderers close over the mode
    try:
        return np.asarray(render_frame(
            scene, meta, state or FrameState.initial(), w, h))
    finally:
        mesh_intersect.PALLAS_MODE = None
        build_render_fn.cache_clear()


def clear_kernel_caches():
    """Clear every trace-time-knob consumer (kernel-wrapper jits + the
    renderer lru caches): required after flipping RPT_SHADOW_CULL /
    RPT_REVCONE, since nested jits cache jaxprs keyed only on shapes."""
    from relativitypathtracer_tpu.ops.pallas import mesh_kernels
    from relativitypathtracer_tpu.render import (
        build_render_fn, build_viewer_render_fn)

    mesh_kernels.shared_nearest_hit.clear_cache()
    mesh_kernels.general_min_t.clear_cache()
    build_render_fn.cache_clear()
    build_viewer_render_fn.cache_clear()
