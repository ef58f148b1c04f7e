"""Octree builder invariants (models.octree)."""

import numpy as np
import pytest

from relativitypathtracer_tpu.models.mesh import HostMesh
from relativitypathtracer_tpu.models.obj_loader import read_obj
from relativitypathtracer_tpu.models.octree import tri_box_overlap



pytestmark = pytest.mark.fast  # inner-loop subset


@pytest.fixture(scope="module")
def pear(reference_root):
    mesh = HostMesh()
    read_obj(str(reference_root / "Models" / "pear.obj"), mesh)
    return mesh


def _leaves(oct):
    return [i for i in range(len(oct.node_min)) if oct.node_children[i][0] == -1]


def test_root_bounds_cover_mesh(pear):
    oct = pear.octree
    verts = np.asarray(pear.vertices, np.float32)
    assert np.all(verts >= np.asarray(oct.node_min[0]) - 1e-6)
    assert np.all(verts <= np.asarray(oct.node_max[0]) + 1e-6)


def test_children_partition_parent(pear):
    oct = pear.octree
    for i in range(len(oct.node_min)):
        ch = oct.node_children[i]
        if ch[0] == -1:
            continue
        pmin = np.asarray(oct.node_min[i])
        pmax = np.asarray(oct.node_max[i])
        half = (pmax - pmin) / 2
        for x in range(2):
            for y in range(2):
                for z in range(2):
                    c = ch[z + 2 * y + 4 * x]
                    cmin = np.asarray(oct.node_min[c])
                    np.testing.assert_allclose(cmin, pmin + half * np.array([x, y, z]), atol=1e-5)
                    np.testing.assert_allclose(np.asarray(oct.node_max[c]), cmin + half, atol=1e-5)


def test_leaf_tris_actually_overlap_leaf(pear):
    oct = pear.octree
    verts = np.asarray(pear.vertices, np.float32)
    tri_v = np.asarray(pear.triangles, np.int64).reshape(-1, 9)[:, 0::3]
    checked = 0
    for leaf in _leaves(oct)[:200]:
        s, c = oct.node_tris_index[leaf], oct.node_tris_count[leaf]
        if c == 0:
            continue
        tris = np.asarray(oct.oct_tris[s:s + c])
        ok = tri_box_overlap(
            verts[tri_v[tris, 0]], verts[tri_v[tris, 1]], verts[tri_v[tris, 2]],
            np.asarray(oct.node_min[leaf]), np.asarray(oct.node_max[leaf]),
        )
        assert ok.all()
        checked += 1
    assert checked > 10


def test_every_tri_in_some_leaf(pear):
    oct = pear.octree
    covered = set()
    for leaf in _leaves(oct):
        s, c = oct.node_tris_index[leaf], oct.node_tris_count[leaf]
        covered.update(oct.oct_tris[s:s + c])
    assert covered == set(range(pear.num_tris))


def test_neighbor_links_consistent(pear):
    """neighbors[f] points to a node adjacent across face f (or -1 at the
    boundary): face index pairs (0,1)=z-/z+, (2,3)=x-/x+, (4,5)=y-/y+."""
    oct = pear.octree
    axis_of = {0: 2, 1: 2, 2: 0, 3: 0, 4: 1, 5: 1}
    for i in range(len(oct.node_min)):
        for f in range(6):
            nb = oct.node_neighbors[i][f]
            if nb == -1:
                continue
            a = axis_of[f]
            imin, imax = oct.node_min[i][a], oct.node_max[i][a]
            nmin, nmax = oct.node_min[nb][a], oct.node_max[nb][a]
            if f % 2 == 0:  # negative-direction neighbor: its max == our min
                assert abs(nmax - imin) < 1e-5
            else:
                assert abs(nmin - imax) < 1e-5


def test_tri_box_overlap_basics():
    A = np.array([[0.0, 0.0, 0.0]])
    B = np.array([[1.0, 0.0, 0.0]])
    C = np.array([[0.0, 1.0, 0.0]])
    # triangle in the z=0 plane vs box containing it
    assert tri_box_overlap(A, B, C, np.array([-1.0, -1, -1]), np.array([2.0, 2, 2]))[0]
    # box fully away in +z
    assert not tri_box_overlap(A, B, C, np.array([0.0, 0, 1]), np.array([1.0, 1, 2]))[0]
    # big triangle spanning a small box (no vertex inside)
    A2 = np.array([[-10.0, -10.0, 0.0]])
    B2 = np.array([[10.0, -10.0, 0.0]])
    C2 = np.array([[0.0, 20.0, 0.0]])
    assert tri_box_overlap(A2, B2, C2, np.array([-0.5, -0.5, -0.5]), np.array([0.5, 0.5, 0.5]))[0]
