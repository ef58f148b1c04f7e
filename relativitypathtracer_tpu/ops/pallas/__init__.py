"""Pallas kernels (the Triton mesh walks of mesh_kernels).

Shared helper: explicit varying-manual-axes (vma) hints for pallas_call
out_shapes, required by jax 0.9's shard_map static replication check.
"""

from __future__ import annotations

import jax

__all__ = ["ray_vma"]


def ray_vma(*xs):
    """Union of the varying-manual-axes of the kernel's traced ray inputs.

    Under ``shard_map(check_vma=True)`` jax 0.9 requires every pallas_call
    out_shape to declare its vma explicitly (pallas_call.py raises
    otherwise). Every per-ray kernel output varies exactly like its ray
    inputs -- scene constants are replicated -- so the union of the ray
    operands' vma is the correct declaration. Outside shard_map all avals
    carry an empty vma and the hint is a no-op.
    """
    v = frozenset()
    for x in xs:
        v = v | (getattr(jax.typeof(x), "vma", None) or frozenset())
    return v
