"""Scene graph, OBJ/b3df loaders, JSON scene round-trip, image I/O."""

import json
import os

import numpy as np
import pytest

from ba_pathtracing_fur.scene import binmesh, graph, io as scene_io, obj
from ba_pathtracing_fur.utils import film

CUBE_OBJ = """
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""


@pytest.fixture
def cube_path(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    return str(p)


def test_obj_loader_fan_triangulation(cube_path):
    m = obj.load_obj(cube_path)
    assert m.faces.shape == (12, 3)  # 6 quads -> 12 triangles
    assert m.vertices.shape[0] == 8
    assert m.normals is not None and np.isfinite(m.normals).all()


def test_binmesh_roundtrip(cube_path, tmp_path):
    m = obj.load_obj(cube_path)
    out = str(tmp_path / "cube.b3df")
    binmesh.save_binary_mesh(out, m)
    m2 = binmesh.load_binary_mesh(out)
    np.testing.assert_array_equal(m2.vertices, m.vertices)
    np.testing.assert_array_equal(m2.faces, m.faces)
    np.testing.assert_allclose(m2.normals, m.normals)


def test_json_scene_load_flatten_render(cube_path, tmp_path):
    scene_json = {
        "Material": [
            {"name": "white", "diffuse": [0.7, 0.7, 0.7],
             "bsdf": "LambertianReflectionBSDF"},
        ],
        "Mesh": [{"path": "cube.obj"}],
        "Node": [
            {"object": "mesh", "object_id": 0, "mesh_id": 0, "material_id": 0,
             "translation": [0, 0, 0], "scale": [1, 1, 1], "name": "cube"},
            {"object": "light", "object_id": 1, "kind": "point",
             "position": [0, 3, 3], "color": [5, 5, 5], "radius": 0.1,
             "constant": 1.0},
            {"object": "camera", "object_id": 2, "position": [0, 0, 6],
             "look_at": [0, 0, 0], "up_vector": [0, 1, 0]},
        ],
        "Environment": {"color": [0.1, 0.1, 0.2], "light": [0.05, 0.05, 0.05]},
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(scene_json))

    g = scene_io.load_scene_json(str(p))
    assert len(g.materials) == 1
    assert g.active_camera is not None

    scene, cam = graph.flatten(g)
    assert scene.tris.count == 12
    assert scene.lights.count == 1
    cam = cam.replace(resolution=(16, 16))

    import jax
    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    img = np.asarray(render_image(scene, cam, jax.random.key(0),
                                  RenderConfig(depth=2, spp=2, ray_chunk=1024)))
    assert np.isfinite(img).all()
    assert img.std() > 1e-4


def test_json_scene_fur_section(cube_path, tmp_path):
    scene_json = {
        "Material": [{"name": "white"}],
        "Mesh": [{"path": "cube.obj"}],
        "Node": [{"object": "mesh", "object_id": 0, "mesh_id": 0,
                  "material_id": 0}],
        "Fur": {"fibers_per_face": 2, "fiber_verts": 3, "radius": 0.01},
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(scene_json))
    g = scene_io.load_scene_json(str(p))
    scene, _ = graph.flatten(g)
    assert scene.cones.count == 12 * 2 * 2  # faces * fibers * (verts-1)
    # fur material auto-added (CPU_Scene.cpp:115-117)
    assert scene.materials.count == 2


def test_scene_json_roundtrip(cube_path, tmp_path):
    g = graph.SceneGraph()
    g.materials.append(dict(name="white", diffuse=(0.6, 0.6, 0.6)))
    m = obj.load_obj(cube_path)
    m.material_ids = [0]
    node = graph.SceneNode(m, graph.MESH,
                           transform=graph.trs_matrix((1, 2, 3)))
    g.root.attach(node)
    g.root.attach(graph.SceneNode(graph.LightDesc(kind="sun"), graph.LIGHT))
    out = str(tmp_path / "exported.json")
    scene_io.save_scene_json(g, out)

    g2 = scene_io.load_scene_json(out)
    s1, _ = graph.flatten(g)
    s2, _ = graph.flatten(g2)
    np.testing.assert_allclose(np.asarray(s2.tris.v0), np.asarray(s1.tris.v0),
                               rtol=1e-6)
    assert s2.lights.count == 1


def test_trs_matrix_translation_applies():
    m = graph.trs_matrix((1, 2, 3))
    p = m @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [1, 2, 3])


def test_png_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(17, 23, 3).astype(np.float32)
    p = str(tmp_path / "t.png")
    film.write_png(p, img)
    back = film.read_png(p)
    assert back.shape == (17, 23, 3)
    np.testing.assert_allclose(back, np.clip(img, 0, 1), atol=0.02)


def test_cli_convert_and_render(cube_path, tmp_path, monkeypatch):
    from ba_pathtracing_fur import cli
    out_mesh = str(tmp_path / "cube.b3df")
    assert cli.main(["convert", cube_path, out_mesh]) == 0
    assert os.path.exists(out_mesh)

    out_img = str(tmp_path / "r.png")
    rc = cli.main(["render", "-s", "cornell", "-r", "2", "-W", "16", "-H", "16",
                   "-d", "2", "-o", out_img, "--ray-chunk", "1024"])
    assert rc == 0 and os.path.exists(out_img)


def _write_ascii_ply(path):
    # unit quad as ONE 4-gon face (exercises fan triangulation) + vertex
    # colors; no normals (exercises smooth-normal generation)
    path.write_text("\n".join([
        "ply", "format ascii 1.0", "comment test quad",
        "element vertex 4",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "element face 1",
        "property list uchar int vertex_indices",
        "end_header",
        "0 0 0 255 0 0", "1 0 0 255 0 0", "1 1 0 255 0 0", "0 1 0 255 0 0",
        "4 0 1 2 3", ""]))


def test_ply_ascii_loader(tmp_path):
    from ba_pathtracing_fur.scene import ply
    p = tmp_path / "quad.ply"
    _write_ascii_ply(p)
    m = ply.load_ply(str(p))
    assert m.vertices.shape == (4, 3)
    assert m.faces.shape == (2, 3)  # 4-gon -> 2 tris (fan)
    # generated smooth normals all +z for a planar quad
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4, atol=1e-6)
    # vertex colors -> diffuse
    assert abs(m.material_defs[0]["diffuse"][0] - 1.0) < 1e-6
    assert m.material_defs[0]["diffuse"][1] == 0.0
    assert m.material_defs[0]["ior"] == 1.56  # createMeshFromAi default


def test_ply_binary_roundtrip_matches_ascii(tmp_path):
    import struct
    from ba_pathtracing_fur.scene import ply
    pa = tmp_path / "a.ply"
    _write_ascii_ply(pa)
    ref = ply.load_ply(str(pa))
    # same quad, binary little-endian, with explicit normals + uvs
    pb = tmp_path / "b.ply"
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        "element vertex 4",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property float u", "property float v",
        "element face 1",
        "property list uchar int vertex_indices",
        "end_header", ""]).encode()
    verts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)]
    body = b""
    for (x, y, z), (u, v) in zip(verts, [(0, 0), (1, 0), (1, 1), (0, 1)]):
        body += struct.pack("<8f", x, y, z, 0, 0, 1, u, v)
    body += struct.pack("<B4i", 4, 0, 1, 2, 3)
    pb.write_bytes(header + body)
    m = ply.load_ply(str(pb))
    np.testing.assert_allclose(m.vertices, ref.vertices)
    np.testing.assert_array_equal(m.faces, ref.faces)
    np.testing.assert_allclose(m.normals, ref.normals, atol=1e-6)
    assert m.uvs is not None and m.uvs.shape == (4, 2)


def test_json_scene_with_ply_renders(tmp_path):
    import jax
    from ba_pathtracing_fur.models.pathtracer import (
        RenderConfig, render_image)
    p = tmp_path / "quad.ply"
    _write_ascii_ply(p)
    scene_json = {
        "Mesh": [{"path": "quad.ply"}],
        "Node": [
            {"object": "mesh", "object_id": 0, "mesh_id": 0, "name": "quad"},
            {"object": "light", "object_id": 1, "kind": "point",
             "position": [0.5, 0.5, 1.5], "color": [8, 8, 8],
             "radius": 0.1, "constant": 1.0},
            {"object": "camera", "object_id": 2, "position": [0.5, 0.5, 2.0],
             "look_at": [0.5, 0.5, 0.0], "up_vector": [0, 1, 0],
             "resolution": [16, 16]},
        ],
        "Environment": {"color": [0.1, 0.1, 0.1]},
    }
    jp = tmp_path / "scene.json"
    jp.write_text(json.dumps(scene_json))
    g = scene_io.load_scene_json(str(jp))
    scene, cam = graph.flatten(g)
    assert scene.tris.count == 2  # the PLY quad, fan-triangulated
    img = np.asarray(render_image(scene, cam, jax.random.key(0),
                                  RenderConfig(depth=2, spp=2,
                                               ray_chunk=256)))
    assert np.all(np.isfinite(img))
    # the lit quad must rise above the 0.1 environment color
    assert img.max() > 0.3
