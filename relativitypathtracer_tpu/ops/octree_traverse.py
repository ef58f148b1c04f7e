"""Stackless octree traversal as a masked lax.while_loop (all-jnp).

Functional port of the reference's neighbor-walk traversal
(intersect_octree, /root/reference/opencl_kernel.cl:200-308): descend to the
leaf containing the ray entry point, test the leaf's triangles, then hop to
the face-exit neighbor; repeat until the walk leaves the tree or passes the
best hit. Every ray advances in lockstep with masked lanes.

This exists for component parity and as the arbiter implementation for
tests; the production path is the culled chunk walk of
ops.pallas.mesh_kernels (Triton on a GPU) or the jnp scan. Here each step
performs per-ray gathers of node fields and diverges per ray, which is fine
for validation runs.

Trip counts: the outer loop tests one triangle per active ray per iteration
(cursor within the current leaf), or performs one neighbor-hop + descent when
the leaf is exhausted; it runs until every lane is done (bounded by
iteration_cap for safety).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import apply_affine3, apply_linear3, apply_normal3, norm3, normalize3

EPSILON = 1e-7
INF = 1e20


def _aabb_entry(bmin, bmax, o, dh):
    """Slab test; returns (t_near, t_far, hit). o/dh: (3, N); bmin/bmax (3, N)."""
    inv = 1.0 / dh
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.max(tmin, axis=0)
    far = jnp.min(tmax, axis=0)
    return near, far, (near <= far) & (far > 0)


def _descend(mesh, node, pos):
    """Descend from `node` to the leaf containing normalized position `pos`.

    Mirrors the child-index round + fmod reparametrization
    (opencl_kernel.cl:236-241). node: (N,), pos: (3, N) in [0,1] node-local.
    """
    def step(_, carry):
        node, pos = carry
        ch = mesh.node_children[node]  # (N, 8)
        is_inner = ch[:, 0] != -1
        # OpenCL round() is half-AWAY-from-zero; jnp.round is half-to-even,
        # which at exact cell centers (0.5) would pick the low child while
        # the fmod reparametrization assumes the high one.
        def rnd(x):
            return jnp.floor(x + 0.5).astype(jnp.int32)

        ci = rnd(pos[2]) + 2 * rnd(pos[1]) + 4 * rnd(pos[0])
        ci = jnp.clip(ci, 0, 7)
        child = jnp.take_along_axis(ch, ci[:, None], axis=1)[:, 0]
        # jnp.fmod = C fmod (truncated); jnp.mod's floor semantics would
        # differ for marginally negative boundary coordinates.
        new_pos = 2.0 * jnp.fmod(jnp.minimum(pos, 1.0 - EPSILON), 0.5)
        return (
            jnp.where(is_inner, child, node),
            jnp.where(is_inner[None, :], new_pos, pos),
        )

    # Depth is bounded by the builder's MAX_DEPTH=6; 8 steps are safe.
    return jax.lax.fori_loop(0, 8, step, (node, pos))


def _exit_face(sdir, pos):
    """Advance node-normalized pos to the exit face along sdir; returns
    (face, new_pos). Mirrors getOppositeBoxSide (opencl_kernel.cl:172-198)."""
    inv = 1.0 / sdir
    s = (inv < 0).astype(jnp.int32)  # (3, N)
    d = (1.0 - s.astype(jnp.float32) - pos) * inv  # (3, N)
    dx, dy, dz = d[0], d[1], d[2]
    take_x = (dx < dy) & (dx < dz)
    take_y = ~take_x & (dy < dz)
    take_z = ~take_x & ~take_y
    step = jnp.where(take_x, dx, jnp.where(take_y, dy, dz))
    new_pos = pos + sdir * step
    face = jnp.where(
        take_x, 3 - s[0], jnp.where(take_y, 5 - s[1], 1 - s[2])
    )
    return face, new_pos


def octree_intersect(mesh, root: int, m4, inv_m, o3, d3, *, iteration_cap=16384):
    """Nearest-hit via octree walk. o3: (3,) shared origin; d3: (3, N).

    Returns (t, normal (3, N), uv (2, N), valid, converged): identical hit
    semantics to mesh_intersect_shared, plus a scalar bool that is False iff
    the iteration cap stopped the walk with lanes still active -- in which
    case results may be incomplete and MUST NOT be used as an oracle.
    (This walker is validation-grade; the cap exists only to bound the
    compiled loop, and exhausting it must never masquerade as a clean run.)
    """
    n = d3.shape[1]
    ro = apply_affine3(inv_m, o3)  # (3,)
    d = apply_linear3(inv_m, d3)
    dh = d / norm3(d)
    o = jnp.broadcast_to(ro[:, None], dh.shape)

    root_arr = jnp.full((n,), root, jnp.int32)
    bmin = mesh.node_min[root_arr].T  # (3, N)
    bmax = mesh.node_max[root_arr].T
    near, far, hit_root = _aabb_entry(bmin, bmax, o, dh)
    pos_world = o + dh * near

    # Origin-inside handling (opencl_kernel.cl:233-248): descend from the
    # root by normalized origin position, then re-enter that leaf.
    inside = near < 0
    norm_pos = (o - bmin) / (bmax - bmin)
    node_in, _ = _descend(mesh, root_arr, norm_pos)
    lb_min = mesh.node_min[node_in].T
    lb_max = mesh.node_max[node_in].T
    near2, far2, hit_leaf = _aabb_entry(lb_min, lb_max, o, dh)
    pos_world = jnp.where(inside[None, :], o + dh * near2, pos_world)
    node = jnp.where(inside, node_in, root_arr)
    active = hit_root & jnp.where(inside, hit_leaf, True)

    ext0 = mesh.node_max[node].T - mesh.node_min[node].T
    sdir = normalize3(dh / ext0)

    best_t = jnp.full((n,), INF)
    best_u = jnp.zeros((n,))
    best_v = jnp.zeros((n,))
    best_tri = jnp.zeros((n,), jnp.int32)

    # Walk state: current node (descend pending), node-normalized pos,
    # triangle cursor (-1 => need descend), active mask.
    cursor = jnp.full((n,), -1, jnp.int32)

    def cond(state):
        return jnp.any(state[0]) & (state[-1] < iteration_cap)

    def body(state):
        active, node, pos_w, cursor, best_t, best_u, best_v, best_tri, it = state

        need_descend = cursor < 0
        # --- descend phase (masked): normalize into node, walk to leaf ---
        nmin = mesh.node_min[node].T
        nmax = mesh.node_max[node].T
        pos_norm = (pos_w - nmin) / (nmax - nmin)
        node_d, _pos_d = _descend(mesh, node, pos_norm)
        node = jnp.where(active & need_descend, node_d, node)
        cursor = jnp.where(active & need_descend, 0, cursor)

        # --- triangle test phase: one tri per iteration per lane ---
        t_idx = mesh.node_tris_index[node]
        t_cnt = mesh.node_tris_count[node]
        in_leaf = cursor < t_cnt
        tri = mesh.oct_tris[jnp.clip(t_idx + cursor, 0, mesh.oct_tris.shape[0] - 1)]
        tv = mesh.tri_v[tri]  # (N, 3)
        A = mesh.vertices[tv[:, 0]].T  # (3, N)
        B = mesh.vertices[tv[:, 1]].T
        C = mesh.vertices[tv[:, 2]].T
        e1 = B - A
        e2 = C - A
        pvec = jnp.cross(dh, e2, axis=0)
        det = jnp.sum(e1 * pvec, axis=0)
        tvec = o - A
        u = jnp.sum(tvec * pvec, axis=0) / det
        qvec = jnp.cross(tvec, e1, axis=0)
        v = jnp.sum(dh * qvec, axis=0) / det
        dist = jnp.sum(e2 * qvec, axis=0) / det
        ok = (
            active & in_leaf
            & (jnp.abs(det) >= EPSILON)
            & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
            & (dist >= 0) & (dist < best_t)
        )
        best_t = jnp.where(ok, dist, best_t)
        best_u = jnp.where(ok, u, best_u)
        best_v = jnp.where(ok, v, best_v)
        best_tri = jnp.where(ok, tri, best_tri)
        cursor = jnp.where(active & in_leaf, cursor + 1, cursor)

        # --- neighbor-hop phase for lanes whose leaf is exhausted ---
        exhausted = active & ~in_leaf & (cursor >= 0)
        nmin = mesh.node_min[node].T
        nmax = mesh.node_max[node].T
        ext = nmax - nmin
        pos_norm = (pos_w - nmin) / ext
        face, pos_exit = _exit_face(sdir, pos_norm)
        pos_w_new = nmin + pos_exit * ext
        nb = jnp.take_along_axis(mesh.node_neighbors[node], face[:, None], axis=1)[:, 0]
        walked_past = norm3(pos_w_new - o) > best_t
        leave = exhausted & ((nb == -1) | walked_past)
        hop = exhausted & ~leave
        active = active & ~leave
        node = jnp.where(hop, nb, node)
        pos_w = jnp.where(hop[None, :], pos_w_new, pos_w)
        cursor = jnp.where(hop, -1, cursor)

        return (active, node, pos_w, cursor, best_t, best_u, best_v, best_tri, it + 1)

    state = (active, node, pos_world, cursor, best_t, best_u, best_v, best_tri,
             jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    final_active, _, _, _, best_t, best_u, best_v, best_tri, _ = state
    converged = ~jnp.any(final_active)  # False => cap exhausted mid-walk

    valid = best_t < INF
    tri = jnp.clip(best_tri, 0, mesh.tri_v.shape[0] - 1)
    w0 = 1.0 - best_u - best_v
    tn = mesh.tri_n[tri]
    nrm = (
        w0 * mesh.normals[tn[:, 0]].T
        + best_u * mesh.normals[tn[:, 1]].T
        + best_v * mesh.normals[tn[:, 2]].T
    )
    normal = normalize3(apply_normal3(inv_m, nrm))
    tuv = mesh.tri_uv[tri]
    uv = (
        w0 * mesh.uvs[tuv[:, 0]].T
        + best_u * mesh.uvs[tuv[:, 1]].T
        + best_v * mesh.uvs[tuv[:, 2]].T
    )
    obj_pt = ro[:, None] + best_t * dh
    world_pt = apply_affine3(m4, obj_pt)
    t = norm3(world_pt - o3[:, None]) / norm3(d3)
    t = jnp.where(valid, t, INF)
    return t, normal, uv, valid, converged
