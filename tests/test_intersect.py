"""Intersection kernel tests: triangle, cone, lights, brute-force scene."""

import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.ops import bruteforce, intersect as isect
from ba_pathtracing_fur.scene.types import (
    DeviceScene, Environment, empty_cone_pack, empty_triangle_pack,
    make_cone_pack, make_light_pack, make_material_table, make_triangle_pack,
)


def _single_tri_scene():
    pack = make_triangle_pack(
        v0=[[-1.0, -1.0, -2.0]], v1=[[1.0, -1.0, -2.0]], v2=[[0.0, 1.0, -2.0]],
        mat_id=[0])
    return DeviceScene(tris=pack, cones=empty_cone_pack(),
                       materials=make_material_table([{"name": "m"}]),
                       lights=make_light_pack([]), env=Environment())


def test_triangle_hit_and_miss():
    scene = _single_tri_scene()
    o = jnp.array([[0.0, 0.0, 0.0], [5.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = bruteforce.closest_hit(o, d, scene)
    assert bool(hit.valid[0]) and not bool(hit.valid[1])
    np.testing.assert_allclose(float(hit.t[0]), 2.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(hit.position[0]), [0, 0, -2], atol=1e-5)
    # interpolated normal faces +z (CCW winding toward camera)
    assert abs(float(hit.normal[0, 2])) > 0.99


def test_cone_cylinder_hit():
    # straight cylinder along +y, radius 0.5, from origin to (0,2,0)
    cones = make_cone_pack(base=[[0.0, 0.0, 0.0]], apex=[[0.0, 2.0, 0.0]],
                           r_base=[0.5], r_apex=[0.5], mat_id=[0])
    scene = DeviceScene(tris=empty_triangle_pack(), cones=cones,
                        materials=make_material_table([{"name": "m"}]),
                        lights=make_light_pack([]), env=Environment())
    o = jnp.array([[2.0, 1.0, 0.0], [2.0, 5.0, 0.0], [0.0, 1.0, 0.0]])
    d = jnp.array([[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    hit = bruteforce.closest_hit(o, d, scene)
    # ray 0: hits the wall at x=0.5 (t=1.5), entering
    assert bool(hit.valid[0])
    np.testing.assert_allclose(float(hit.t[0]), 1.5, atol=1e-4)
    assert bool(hit.enter[0])
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [1, 0, 0], atol=1e-4)
    # ray 1: above the cylinder -> miss
    assert not bool(hit.valid[1])
    # ray 2: from inside -> exit hit at x=0.5 (t=0.5), not entering
    assert bool(hit.valid[2])
    np.testing.assert_allclose(float(hit.t[2]), 0.5, atol=1e-4)
    assert not bool(hit.enter[2])


def test_cone_taper_radius():
    # cone tapering 0.5 -> 0.0 over height 1: at y=0.5 radius is 0.25
    cones = make_cone_pack(base=[[0.0, 0.0, 0.0]], apex=[[0.0, 1.0, 0.0]],
                           r_base=[0.5], r_apex=[0.0], mat_id=[0])
    scene = DeviceScene(tris=empty_triangle_pack(), cones=cones,
                        materials=make_material_table([{"name": "m"}]),
                        lights=make_light_pack([]), env=Environment())
    o = jnp.array([[2.0, 0.5, 0.0]])
    d = jnp.array([[-1.0, 0.0, 0.0]])
    hit = bruteforce.closest_hit(o, d, scene)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(float(hit.t[0]), 1.75, atol=1e-4)
    # slanted normal: radial + slope * axis
    n = np.asarray(hit.normal[0])
    assert n[0] > 0.8 and n[1] > 0.1


def test_cone_texcoord_range():
    cones = make_cone_pack(base=[[0.0, 0.0, 0.0]], apex=[[0.0, 2.0, 0.0]],
                           r_base=[0.5], r_apex=[0.5], mat_id=[0])
    scene = DeviceScene(tris=empty_triangle_pack(), cones=cones,
                        materials=make_material_table([{"name": "m"}]),
                        lights=make_light_pack([]), env=Environment())
    o = jnp.array([[2.0, 1.0, 0.0]])
    d = jnp.array([[-1.0, 0.0, 0.0]])
    hit = bruteforce.closest_hit(o, d, scene)
    uv = np.asarray(hit.uv[0])
    assert 0.0 <= uv[0] <= 1.0
    np.testing.assert_allclose(uv[1], 0.5, atol=1e-4)  # halfway up


def test_any_hit_shadow():
    scene = _single_tri_scene()
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    t_max = jnp.array([10.0, 10.0])
    blocked = bruteforce.any_hit(o, d, scene, t_max)
    assert bool(blocked[0]) and not bool(blocked[1])
    # occluder beyond t_max does not block
    blocked2 = bruteforce.any_hit(o, d, scene, jnp.array([1.0, 1.0]))
    assert not bool(blocked2[0])


def test_light_intersections():
    lights = make_light_pack([
        dict(kind="point", color=(1, 1, 1), position=(0.0, 0.0, -3.0), radius=0.5),
        dict(kind="quad", color=(1, 1, 1), position=(0.0, 2.0, 0.0),
             direction=(0.0, -1.0, 0.0), size=(1.0, 1.0)),
        dict(kind="sun", color=(1, 1, 1), direction=(0.0, -1.0, 0.0)),
    ])
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, valid = isect.light_hit_grid(o, d, lights)
    assert bool(valid[0, 0])  # point sphere hit
    np.testing.assert_allclose(float(t[0, 0]), 2.5, atol=1e-4)
    assert not bool(valid[0, 1])  # quad is overhead
    assert not bool(valid[0, 2])  # sun never intersects
    # straight up hits the quad
    d2 = jnp.array([[0.0, 1.0, 0.0]])
    t2, valid2 = isect.light_hit_grid(o, d2, lights)
    assert bool(valid2[0, 1])
    np.testing.assert_allclose(float(t2[0, 1]), 2.0, atol=1e-4)


def test_chunked_equals_unchunked():
    scene = _single_tri_scene()
    n = 1000
    rs = np.random.RandomState(0)
    o = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    d = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    h1 = bruteforce.closest_hit(o, d, scene, chunk=128)
    h2 = bruteforce.closest_hit(o, d, scene, chunk=4096)
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(h1.valid), np.asarray(h2.valid))
