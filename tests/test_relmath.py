"""Unit tests for the relativity/affine math core (ops.relmath)."""

import numpy as np
import pytest

from relativitypathtracer_tpu.ops import relmath

RNG = np.random.default_rng(0)
ETA = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)  # Minkowski metric (-+++)



pytestmark = pytest.mark.fast  # inner-loop subset


def rand_velocity(n=1, vmax=0.95):
    v = RNG.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / norm * RNG.uniform(0.05, vmax, size=(n, 1)).astype(np.float32)


def test_lorentz_zero_velocity_is_identity():
    M = np.asarray(relmath.lorentz(np.zeros(3, np.float32)))
    np.testing.assert_array_equal(M, np.eye(4, dtype=np.float32))


def test_lorentz_times_inverse_is_identity():
    v = rand_velocity(8)
    L = np.asarray(relmath.lorentz(v))
    Linv = np.asarray(relmath.lorentz(-v))
    prod = np.einsum("bij,bjk->bik", L, Linv)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), prod.shape), atol=2e-5)


def test_lorentz_preserves_minkowski_interval():
    v = rand_velocity(8)
    L = np.asarray(relmath.lorentz(v))
    # L^T eta L == eta for a Lorentz transform
    g = np.einsum("bji,jk,bkl->bil", L, ETA, L)
    np.testing.assert_allclose(g, np.broadcast_to(ETA, g.shape), atol=2e-5)


def test_lorentz_gamma_factor():
    v = np.array([0.6, 0.0, 0.0], np.float32)
    L = np.asarray(relmath.lorentz(v))
    gamma = 1.0 / np.sqrt(1.0 - 0.36)
    assert L[0, 0] == pytest.approx(gamma, rel=1e-6)
    assert L[0, 1] == pytest.approx(-0.6 * gamma, rel=1e-6)


def test_add_velocity_parallel_matches_closed_form():
    # Parallel velocities: (u + w) / (1 + u w)
    u, w = 0.5, 0.3
    out = np.asarray(relmath.add_velocity(
        np.array([u, 0, 0], np.float32), np.array([w, 0, 0], np.float32)
    ))
    np.testing.assert_allclose(out, [(u + w) / (1 + u * w), 0, 0], atol=1e-6)


def test_add_velocity_never_exceeds_c():
    for _ in range(50):
        v1 = rand_velocity()[0]
        v2 = rand_velocity()[0]
        out = np.asarray(relmath.add_velocity(v1, v2))
        assert np.linalg.norm(out) < 1.0


def test_add_velocity_with_zero():
    v = rand_velocity()[0]
    np.testing.assert_allclose(
        np.asarray(relmath.add_velocity(v, np.zeros(3, np.float32))), v, atol=1e-7
    )


def test_trs_identity():
    M = np.asarray(relmath.trs(np.zeros(3), 0.0, np.zeros(3), np.ones(3)))
    np.testing.assert_allclose(M, np.eye(4), atol=0)


def test_trs_composition_structure():
    t = np.array([1.0, 2.0, 3.0], np.float32)
    s = np.array([2.0, 3.0, 4.0], np.float32)
    M = np.asarray(relmath.trs(t, 0.0, np.array([0, 1, 0], np.float32), s))
    np.testing.assert_allclose(M[:3, 3], t)
    np.testing.assert_allclose(np.diag(M)[:3], s)


def test_trs_rotation_orthonormal():
    M = np.asarray(relmath.trs(np.zeros(3), 0.7854, np.array([0.0, 1.0, 0.0]), np.ones(3)))
    R = M[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-6)


def test_inverse4_roundtrip():
    for _ in range(20):
        t = RNG.uniform(-5, 5, 3).astype(np.float32)
        angle = float(RNG.uniform(0, 3))
        axis = RNG.uniform(-1, 1, 3).astype(np.float32)
        scale = RNG.uniform(0.2, 3.0, 3).astype(np.float32)
        M = np.asarray(relmath.trs(t, angle, axis, scale))
        Minv = np.asarray(relmath.inverse4(M))
        np.testing.assert_allclose(M @ Minv, np.eye(4), atol=1e-4)


def test_inverse4_batched():
    Ms = np.stack([
        np.asarray(relmath.trs(RNG.uniform(-2, 2, 3), float(RNG.uniform(0, 3)),
                               RNG.uniform(-1, 1, 3), RNG.uniform(0.5, 2, 3)))
        for _ in range(5)
    ])
    invs = np.asarray(relmath.inverse4(Ms))
    prod = np.einsum("bij,bjk->bik", Ms, invs)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), prod.shape), atol=1e-4)


def test_transform_helpers():
    M = np.asarray(relmath.trs(np.array([1, 0, 0]), 0.0, np.zeros(3), np.array([2, 2, 2])))
    p = np.array([1.0, 1.0, 1.0], np.float32)
    np.testing.assert_allclose(np.asarray(relmath.transform_point3(M, p)), [3, 2, 2])
    np.testing.assert_allclose(np.asarray(relmath.transform_dir3(M, p)), [2, 2, 2])


def test_lorentz_pair_consistency():
    v = rand_velocity()[0]
    L, Linv = relmath.lorentz_pair(v)
    np.testing.assert_array_equal(np.asarray(Linv), np.asarray(relmath.lorentz(-v)))


def test_add_velocity_np_matches_jnp():
    """The viewer's host-side numpy composition (framestate.add_velocity_np)
    must reproduce ops.relmath.add_velocity: the interactive key handling and
    the renderer's boost chain share these velocities."""
    from relativitypathtracer_tpu.utils.framestate import add_velocity_np

    rng = np.random.default_rng(11)
    for _ in range(50):
        v1 = (rng.uniform(-0.6, 0.6, 3)).astype(np.float32)
        v2 = (rng.uniform(-0.4, 0.4, 3)).astype(np.float32)
        ref = np.asarray(relmath.add_velocity(v1, v2))
        got = add_velocity_np(v1, v2)
        np.testing.assert_allclose(got, ref, atol=2e-7)
