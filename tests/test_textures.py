"""End-to-end texture pipeline: MTL import, JSON texture refs, atlas
resolution in flatten, textured shading, cube env, round-trip.

Reference behaviors covered: Material::fetchParameterColor/-Float
(Material.h:153-216, Material.cpp:15-23), jsonin material *_map keys
(jsonin.cpp:403-465), Environment cube/sphere maps (jsonin.cpp:295-345,
Environment.h:18-100), createMeshFromAi OBJ material import
(SceneGraph.cpp:145-180)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.models import bsdf as bsdf_mod
from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.scene import graph as graph_mod, io as scene_io, obj
from ba_pathtracing_fur.scene.texture import build_atlas, fetch_bilinear
from ba_pathtracing_fur.scene.types import make_material_table
from ba_pathtracing_fur.utils import film

QUAD_OBJ = """
mtllib quad.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
usemtl painted
f 1/1/1 2/2/1 3/3/1 4/4/1
"""

QUAD_MTL = """
newmtl painted
Kd 0.2 0.4 0.8
Ks 0.1 0.1 0.1
Ns 250
Ni 1.45
d 0.75
map_Kd paint.png
"""


@pytest.fixture
def textured_obj(tmp_path):
    # 2x2 checker texture: red / green quadrants
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:4, :4] = (1.0, 0.0, 0.0)
    tex[4:, 4:] = (1.0, 0.0, 0.0)
    tex[:4, 4:] = (0.0, 1.0, 0.0)
    tex[4:, :4] = (0.0, 1.0, 0.0)
    film.write_png(str(tmp_path / "paint.png"), tex, gamma=2.2)
    (tmp_path / "quad.obj").write_text(QUAD_OBJ)
    (tmp_path / "quad.mtl").write_text(QUAD_MTL)
    return tmp_path


def test_mtl_parsing(textured_obj):
    m = obj.load_obj(str(textured_obj / "quad.obj"))
    assert m.material_slot_names == ["default", "painted"]
    d = m.material_defs[1]
    assert d["diffuse"] == (0.2, 0.4, 0.8)
    assert d["specular"] == (0.1, 0.1, 0.1)
    assert abs(d["roughness"] - 0.75) < 1e-6  # Ns 250 -> 1 - 250/1000
    assert abs(d["ior"] - 1.45) < 1e-6
    assert abs(d["transparency"] - 0.25) < 1e-6  # d 0.75
    assert d["diffuse_map"].endswith("paint.png")
    assert os.path.isabs(d["diffuse_map"])
    # defaults from createMeshFromAi (SceneGraph.cpp:175-179)
    assert m.material_defs[0].get("name") == "default"


def test_obj_materials_flow_into_flatten(textured_obj):
    m = obj.load_obj(str(textured_obj / "quad.obj"))
    g = graph_mod.SceneGraph()
    g.root.attach(graph_mod.SceneNode(m, graph_mod.MESH))
    scene, _ = graph_mod.flatten(g)
    assert scene.textures is not None
    assert scene.textures.images.shape[0] == 1
    assert "diffuse" in scene.tex_slots
    # the painted slot resolved to atlas index 0; mat 0 is 'default'
    painted = int(np.argmax(np.asarray(scene.materials.diffuse_tex) >= 0))
    assert int(scene.materials.diffuse_tex[painted]) == 0


def test_gather_materials_resolves_slots():
    tex_r = np.full((4, 4, 3), (1.0, 0.0, 0.0), np.float32)
    tex_g = np.full((4, 4, 3), (0.0, 0.6, 0.0), np.float32)
    atlas = build_atlas([tex_r, tex_g])
    mats = make_material_table([
        dict(name="plain", diffuse=(0.5, 0.5, 0.5), roughness=0.2),
        dict(name="tex", diffuse=(0.5, 0.5, 0.5), diffuse_tex=0,
             specular_tex=1, roughness_tex=1),
    ])
    mat_id = jnp.array([0, 1], jnp.int32)
    uv = jnp.full((2, 2), 0.5, jnp.float32)
    mp = bsdf_mod.gather_materials(mats, mat_id, uv, atlas,
                                   ("diffuse", "specular", "roughness"))
    np.testing.assert_allclose(mp.diffuse[0], (0.5, 0.5, 0.5), atol=1e-6)
    np.testing.assert_allclose(mp.diffuse[1], (1.0, 0.0, 0.0), atol=1e-6)
    np.testing.assert_allclose(mp.specular[1], (0.0, 0.6, 0.0), atol=1e-6)
    # float slot = |rgba| (Material.cpp:20-23 glm::length of the 4-vector;
    # an alpha-less source stores alpha=1, so the reference-parity length
    # of (0, 0.6, 0, 1) is sqrt(0.36 + 1))
    assert abs(float(mp.roughness[1]) - np.sqrt(0.6 ** 2 + 1.0)) < 1e-5
    assert abs(float(mp.roughness[0]) - 0.2) < 1e-6


def test_alpha_texture_float_slot_length():
    """RGBA atlas (Texture.h:25-90 channels 1-4): a float-slot fetch takes
    the length of the full RGBA like Material.cpp:15-23; a color-slot fetch
    returns RGB unchanged by alpha."""
    rgba = np.zeros((4, 4, 4), np.float32)
    rgba[..., 0] = 0.3  # R
    rgba[..., 3] = 0.4  # A
    atlas = build_atlas([rgba])
    assert atlas.images.shape[-1] == 4
    mats = make_material_table([
        dict(name="m", diffuse=(0.9, 0.9, 0.9), diffuse_tex=0,
             roughness=0.5, roughness_tex=0),
    ])
    mat_id = jnp.zeros((1,), jnp.int32)
    uv = jnp.full((1, 2), 0.5, jnp.float32)
    mp = bsdf_mod.gather_materials(mats, mat_id, uv, atlas,
                                   ("diffuse", "roughness"))
    np.testing.assert_allclose(mp.diffuse[0], (0.3, 0.0, 0.0), atol=1e-6)
    assert abs(float(mp.roughness[0]) - 0.5) < 1e-6  # |(.3,0,0,.4)| = 0.5
    # grey+alpha (2-channel) images broadcast grey to RGB and keep alpha
    ga = np.zeros((2, 2, 2), np.float32)
    ga[..., 0] = 0.6
    ga[..., 1] = 0.8
    at2 = build_atlas([ga])
    got = np.asarray(fetch_bilinear(at2, jnp.zeros((1,), jnp.int32), uv,
                                    channels=4))
    np.testing.assert_allclose(got[0], (0.6, 0.6, 0.6, 0.8), atol=1e-6)


def test_textured_render_differs_from_flat(textured_obj):
    """VERDICT r1 done-criterion: a textured OBJ scene renders via the
    public path and textured pixels differ from the flat-color render."""
    scene_file = textured_obj / "scene.json"
    scene_file.write_text(json.dumps({
        "Mesh": [{"path": "quad.obj"}],
        "Node": [
            {"object": "mesh", "mesh_id": 0, "name": "quad"},
            {"object": "camera", "position": [0, 2.5, 0],
             "look_at": [0, 0, 0], "up_vector": [0, 0, -1],
             "resolution": [32, 32]},
            {"object": "light", "kind": "point", "position": [0, 3, 0],
             "color": [8, 8, 8], "radius": 0.5},
        ],
    }))
    g = scene_io.load_scene_json(str(scene_file))
    scene, cam = graph_mod.flatten(g)
    assert scene.textures is not None
    cfg = RenderConfig(depth=2, spp=4, ray_chunk=4096)
    img = np.asarray(render_image(scene, cam, jax.random.key(0), cfg))
    assert np.all(np.isfinite(img))
    # flat render: same scene with the texture slot disabled
    flat = scene.replace(tex_slots=())
    img_flat = np.asarray(render_image(flat, cam, jax.random.key(0), cfg))
    assert np.abs(img - img_flat).max() > 0.05
    # the checker makes red and green regions — both channels present
    assert img[..., 0].max() > 0.02 and img[..., 1].max() > 0.02


def test_cube_env_load_and_shading(tmp_path):
    """Six distinct face colors; every principal direction must fetch its
    own face (loadCubeMap analog, jsonin.cpp:308-328)."""
    from ba_pathtracing_fur.models import shading
    names = ("posx", "posy", "posz", "negx", "negy", "negz")
    colors = {"posx": (1, 0, 0), "posy": (0, 1, 0), "posz": (0, 0, 1),
              "negx": (1, 1, 0), "negy": (0, 1, 1), "negz": (1, 0, 1)}
    for n in names:
        img = np.full((4, 4, 3), colors[n], np.float32)
        film.write_png(str(tmp_path / f"{n}.png"), img, gamma=2.2)
    scene_file = tmp_path / "scene.json"
    scene_file.write_text(json.dumps({
        "Node": [],
        "Environment": {"kind": "cube",
                        **{n: f"{n}.png" for n in names},
                        "light": [0.1, 0.1, 0.1]},
    }))
    g = scene_io.load_scene_json(str(scene_file))
    assert g.environment["kind"] == 2
    assert g.environment["texture"].shape[0] == 6
    scene, _ = graph_mod.flatten(g)
    dirs = {"posx": (1, 0, 0), "negx": (-1, 0, 0), "posy": (0, 1, 0),
            "negy": (0, -1, 0), "posz": (0, 0, 1), "negz": (0, 0, -1)}
    d = jnp.asarray([dirs[n] for n in names], jnp.float32)
    got = np.asarray(shading.environment_color(scene.env, d))
    want = np.asarray([colors[n] for n in names], np.float32)
    np.testing.assert_allclose(got, want, atol=0.05)


def test_scene_roundtrip_env_fur_maps(textured_obj):
    """load -> save -> load preserves env kind+texture, Fur params, and
    material texture refs (jsonout.cpp:14-301 parity)."""
    sphere = np.zeros((4, 8, 3), np.float32)
    sphere[:, :4] = (1.0, 0.5, 0.25)
    film.write_png(str(textured_obj / "sky.png"), sphere, gamma=2.2)
    scene_file = textured_obj / "scene.json"
    scene_file.write_text(json.dumps({
        "Material": [{"name": "painted", "diffuse": [0.2, 0.4, 0.8],
                      "diffuse_map": "paint.png"}],
        "Mesh": [{"path": "quad.obj"}],
        "Node": [{"object": "mesh", "mesh_id": 0, "material_id": 0,
                  "name": "quad"}],
        "Environment": {"kind": "sphere", "path": "sky.png",
                        "light": [0.2, 0.1, 0.0]},
        "Fur": {"fibers_per_face": 2, "fiber_verts": 3, "radius": 0.01},
    }))
    g1 = scene_io.load_scene_json(str(scene_file))
    assert g1.environment["kind"] == 1
    assert g1.fur["fibers_per_face"] == 2

    out_dir = textured_obj / "resaved"
    out_dir.mkdir()
    out_file = out_dir / "scene2.json"
    scene_io.save_scene_json(g1, str(out_file))
    g2 = scene_io.load_scene_json(str(out_file))

    assert g2.environment["kind"] == 1
    np.testing.assert_allclose(g2.environment["texture"],
                               g1.environment["texture"], atol=0.02)
    assert g2.fur == g1.fur
    assert g2.materials[0]["diffuse_map"].endswith("paint.png")
    s1, _ = graph_mod.flatten(g1)
    s2, _ = graph_mod.flatten(g2)
    assert s2.textures is not None
    np.testing.assert_allclose(np.asarray(s2.textures.images),
                               np.asarray(s1.textures.images), atol=0.02)
    # fur re-grows identically (same seed)
    assert s2.cones.count == s1.cones.count


def test_fetch_bilinear_native_sizes():
    a = np.zeros((4, 4, 3), np.float32)
    a[:, :2] = 1.0
    b = np.zeros((8, 8, 3), np.float32)
    b[:, 4:] = 1.0
    atlas = build_atlas([a, b])
    tid = jnp.array([0, 0, 1, 1], jnp.int32)
    uv = jnp.asarray([[0.1, 0.5], [0.9, 0.5], [0.1, 0.5], [0.9, 0.5]])
    got = np.asarray(fetch_bilinear(atlas, tid, uv))
    np.testing.assert_allclose(got[:, 0], [1.0, 0.0, 0.0, 1.0], atol=0.1)
