"""Scene layer tests: DSL parser, OBJ loader, texture atlas."""

import numpy as np
import pytest

from relativitypathtracer_tpu.models import dsl
from relativitypathtracer_tpu.models.mesh import HostMesh
from relativitypathtracer_tpu.models.obj_loader import ObjError, read_obj
from relativitypathtracer_tpu.models.scene import CUBE, MESH, SPHERE, build_scene

ALL_SCENES = ["arch", "bunny", "cube", "cubes", "ladder_paradox", "rulers", "shadows", "soccer"]



pytestmark = pytest.mark.fast  # inner-loop subset


def test_parse_simple_scene():
    scene = dsl.parse_scene(
        """Os
 p0,3,15,0,0,1,0,0.1,0.1,0.1
 c1,1,1
 l1
Oc
 p5,0,15,0,0,1,0,1,6,1
 c0.5,0.25,1
R
"""
    )
    assert len(scene.objects) == 2
    s, c = scene.objects
    assert s.obj_type == SPHERE and s.light
    assert c.obj_type == CUBE and not c.light
    np.testing.assert_allclose(c.color, [0.5, 0.25, 1.0])
    np.testing.assert_allclose(s.m[:3, 3], [0, 3, 15])
    np.testing.assert_allclose(np.diag(s.m)[:3], [0.1, 0.1, 0.1])
    # InvM is the actual inverse
    np.testing.assert_allclose(s.m @ s.inv_m, np.eye(4), atol=1e-5)


def test_parse_velocity_flash_ambient_whitepoint_interval():
    scene = dsl.parse_scene(
        """Oc
 p0,0,5,0,0,0,0,1,1,1
 v0.9,0,0
 f2,1
A0.25
W2,2,2
I
R
"""
    )
    ob = scene.objects[0]
    np.testing.assert_allclose(ob.velocity, [0.9, 0, 0])
    assert ob.flash_period == 2.0 and ob.flash_duration == 1.0
    assert scene.ambient == pytest.approx(0.25)
    np.testing.assert_allclose(scene.white_point, [2, 2, 2])
    assert scene.default_interval == 0


def test_parse_stops_at_R():
    scene = dsl.parse_scene("Os\n p0,0,5,0,0,0,0,1,1,1\nR\nOc\n")
    assert len(scene.objects) == 1


def test_command_before_object_raises():
    with pytest.raises(dsl.SceneError):
        dsl.parse_scene("p0,0,0,0,0,0,0,1,1,1\nR\n")


def test_texture_index_out_of_range_raises():
    with pytest.raises(dsl.SceneError):
        dsl.parse_scene("Os\n t3\nR\n")


def test_mesh_index_out_of_range_raises():
    with pytest.raises(dsl.SceneError):
        dsl.parse_scene("Om0\nR\n")


def test_all_reference_scenes_parse(reference_root):
    for name in ALL_SCENES:
        host = dsl.load_scene_file(str(reference_root / "Scenes" / f"{name}.txt"))
        scene, meta = build_scene(host)
        assert meta.num_objects == len(host.objects)
        assert meta.num_objects > 0


def test_reference_scene_shapes(reference_root):
    host = dsl.load_scene_file(str(reference_root / "Scenes" / "arch.txt"))
    scene, meta = build_scene(host)
    # arch.txt: 1 light sphere + 4 cubes, brick texture on the floor
    assert meta.num_objects == 5
    assert meta.sphere_ids == (0,)
    assert len(meta.cube_ids) == 4
    assert meta.light_ids == (0,)
    assert meta.default_interval == -1
    assert float(scene.ambient) == pytest.approx(0.2)
    floor = 4  # last cube carries texture t0
    assert int(scene.objects.tex_offset[floor]) == 0
    assert int(scene.objects.tex_w[floor]) > 0


def test_bunny_scene_missing_blob_substitution(reference_root):
    # bunny.txt references Models/StanfordBunny.obj (missing large blob);
    # resolve_asset should fall back to Models/bunny.obj.
    host = dsl.load_scene_file(str(reference_root / "Scenes" / "bunny.txt"))
    assert host.mesh.num_tris == 4968


def test_shadows_scene_case_insensitive_path(reference_root):
    # shadows.txt says Models/Pear.obj; on-disk file is pear.obj.
    host = dsl.load_scene_file(str(reference_root / "Scenes" / "shadows.txt"))
    assert host.mesh.num_tris == 2848


def test_obj_triangle(reference_root):
    mesh = HostMesh()
    read_obj(str(reference_root / "Models" / "triangle.obj"), mesh)
    assert len(mesh.vertices) == 3
    assert len(mesh.uvs) == 3
    assert len(mesh.normals) == 1
    assert mesh.num_tris == 1
    # flat stream: [v, uv, n] x 3, all zero-based
    assert mesh.triangles == [0, 0, 0, 1, 1, 0, 2, 2, 0]
    assert mesh.mesh_indices == [0]


def test_obj_smooth_normals(tmp_path):
    # Two faces sharing an edge, no vn: smooth normals are generated
    # area-weighted and appended in ascending vertex order.
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1 2 3\nf 1 3 4\n"
    )
    mesh = HostMesh()
    read_obj(str(p), mesh)
    assert mesh.num_tris == 2
    # 4 generated normals (one per vertex), all +z for a planar quad
    assert len(mesh.normals) == 4
    for n in mesh.normals:
        np.testing.assert_allclose(n, [0, 0, 1], atol=1e-6)
    # normal indices patched into the stream: vertex 0 shared by both tris
    assert mesh.triangles[2] == mesh.triangles[2 + 9]


def test_obj_multi_mesh_offsets(tmp_path, reference_root):
    mesh = HostMesh()
    read_obj(str(reference_root / "Models" / "triangle.obj"), mesh)
    read_obj(str(reference_root / "Models" / "triangle.obj"), mesh)
    assert mesh.num_tris == 2
    assert len(mesh.mesh_indices) == 2
    # second triangle's vertex indices offset by the first mesh's pool size
    assert mesh.triangles[9] == 3


def test_obj_rejects_non_obj():
    with pytest.raises(ObjError):
        read_obj("something.txt", HostMesh())


def test_texture_atlas(reference_root):
    from relativitypathtracer_tpu.models.texture import read_texture

    atlas = bytearray()
    values = []
    read_texture(str(reference_root / "Textures" / "box.jpg"), atlas, values)
    off, w, h = values
    assert off == 0 and w > 0 and h > 0
    assert len(atlas) == 3 * w * h
    read_texture(str(reference_root / "Textures" / "tile.jpg"), atlas, values)
    assert values[3] == 3 * w * h  # second texture appended at running offset


def test_tolerant_parse_warns_and_continues(capsys):
    """strict=False mirrors the reference: malformed commands print to stderr
    and parsing continues (Render.cpp:227-259 `break` inside the switch)."""
    from relativitypathtracer_tpu.models.dsl import parse_scene

    text = """c1,0,0
Xjunk
O
Os
 c0.5,0.5,0.5
 q9
R
"""
    host = parse_scene(text, strict=False)
    err = capsys.readouterr().err
    assert "Object must be defined" in err
    assert 'Unrecognized command: "Xjunk"' in err
    assert "Object command missing argument" in err
    assert 'Unrecognized command: "q9"' in err
    assert len(host.objects) == 1  # the valid sphere survived
    assert host.objects[0].color[0] == pytest.approx(0.5)


def test_strict_parse_raises():
    from relativitypathtracer_tpu.models.dsl import SceneError, parse_scene

    with pytest.raises(SceneError):
        parse_scene("Xjunk\nR\n", strict=True)


def test_tolerant_parse_still_hard_fails_index_checks():
    """The two post-pass index checks exit hard in the reference
    (Render.cpp:396-410) and must raise even in tolerant mode."""
    from relativitypathtracer_tpu.models.dsl import SceneError, parse_scene

    with pytest.raises(SceneError, match="Texture index"):
        parse_scene("Os\n t3\nR\n", strict=False)
    with pytest.raises(SceneError, match="Mesh index"):
        parse_scene("Om0\nR\n", strict=False)


def test_tolerant_parse_atoi_semantics():
    """Non-numeric arguments parse like C atoi/atof (0, no crash)."""
    from relativitypathtracer_tpu.models.dsl import parse_scene

    host = parse_scene("Os\n lx\n A0.25zz\nR\n", strict=False)
    assert host.objects[0].light is False  # atoi("x") == 0
    assert host.ambient == pytest.approx(0.25)  # atof("0.25zz") == 0.25
