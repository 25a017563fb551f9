"""LBVH vs the brute-force oracle (SURVEY §4 principle: every accelerated
path has a reference twin)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.ops import bruteforce, traverse
from ba_pathtracing_fur.scene.builtins import cornell_box, fur_patch


def _random_rays(n, seed, lo=-2.0, hi=2.0, aim=None):
    """Random rays; with `aim=(lo3, hi3)` directions point at random targets
    inside that box so most rays actually reach the geometry."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    if aim is None:
        d = rs.normal(size=(n, 3)).astype(np.float32)
    else:
        target = rs.uniform(aim[0], aim[1], (n, 3)).astype(np.float32)
        d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_bvh_closest_matches_bruteforce_tris(leaf_size):
    scene, _ = cornell_box(resolution=(8, 8))
    acc = traverse.attach_bvh(scene, leaf_size=leaf_size, min_prims=1)
    o, d = _random_rays(512, 0)
    ref = bruteforce.closest_hit(o, d, scene)
    got = traverse.closest_hit_bvh(o, d, acc)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=1e-5, atol=1e-6)
    # rays hitting a shared edge tie in t and may pick either triangle;
    # compare normals/materials only where both picked the same primitive
    same = np.asarray(got.prim_id == ref.prim_id)
    m = np.asarray(ref.valid) & same
    assert m.sum() >= np.asarray(ref.valid).sum() - 3  # ties are rare
    np.testing.assert_allclose(np.asarray(got.normal)[m], np.asarray(ref.normal)[m],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.mat_id)[m], np.asarray(ref.mat_id)[m])


def test_bvh_closest_matches_bruteforce_cones():
    scene, _ = fur_patch(resolution=(8, 8), fibers_per_face=20, fiber_verts=5,
                         fiber_radius=0.02)
    acc = traverse.attach_bvh(scene, leaf_size=8, min_prims=1)
    # aim at the fiber volume (patch halfsize 0.5, fibers grow up to ~y=0.1)
    o, d = _random_rays(1024, 1, lo=-1.5, hi=1.5,
                        aim=((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4)))
    ref = bruteforce.closest_hit(o, d, scene)
    got = traverse.closest_hit_bvh(o, d, acc)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    # thin-cone quadratics are ill-conditioned in f32 (disc = b^2 - a*c with
    # near-tangent rays), so grid vs gathered evaluation order legitimately
    # shifts t by ~1e-4 relative; chains also overlap by construction
    # (CPU_Scene.cpp:104-145) so near-ties can swap winners.
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=2e-3, atol=1e-6)
    cone_hits = np.asarray(ref.valid & (ref.prim_type == bruteforce.PRIM_CONE))
    assert cone_hits.sum() > 30
    agree = (np.asarray(got.enter) == np.asarray(ref.enter))[cone_hits]
    assert agree.mean() > 0.9


def test_bvh_any_hit_matches_bruteforce():
    scene, _ = cornell_box(resolution=(8, 8))
    acc = traverse.attach_bvh(scene, min_prims=1)
    o, d = _random_rays(512, 2)
    t_max = jnp.full((512,), 2.5, jnp.float32)
    ref = bruteforce.any_hit(o, d, scene, t_max)
    got = traverse.any_hit_bvh(o, d, acc, t_max)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_bvh_render_matches_bruteforce_image():
    scene, camera = cornell_box(resolution=(24, 24))
    cfg = RenderConfig(depth=3, spp=2, ray_chunk=4096)
    key = jax.random.key(5)
    ref = render_image(scene, camera, key, cfg)
    acc = traverse.attach_bvh(scene, min_prims=1)
    got = render_image(acc, camera, key, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_bvh_render_fur_matches_bruteforce_image():
    scene, camera = fur_patch(resolution=(16, 16), fibers_per_face=2, fiber_verts=3)
    cfg = RenderConfig(depth=3, spp=1, ray_chunk=1024)
    key = jax.random.key(6)
    ref = render_image(scene, camera, key, cfg)
    acc = traverse.attach_bvh(scene, min_prims=1)
    got = render_image(acc, camera, key, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-5)

@pytest.mark.parametrize("method", ["sah", "median", "morton", "grid"])
def test_accel_family_matches_bruteforce(method):
    """Every clustering policy in the accel registry (SAH/KD-median/
    linear-octree-morton/uniform-grid — the Demo/main.cpp:94-127 swap set)
    returns the exact brute-force nearest hit."""
    scene, _ = fur_patch(resolution=(8, 8), fibers_per_face=4, fiber_verts=4,
                         fiber_radius=0.02)
    acc = traverse.attach_bvh(scene, leaf_size=8, method=method, min_prims=1)
    o, d = _random_rays(512, 7, lo=-1.5, hi=1.5,
                        aim=((-0.4, 0.0, -0.4), (0.4, 0.12, 0.4)))
    ref = bruteforce.closest_hit(o, d, scene)
    got = traverse.closest_hit_bvh(o, d, acc)
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=2e-3, atol=1e-6)


def test_accel_debug_info():
    from ba_pathtracing_fur.ops import bvh as bvh_mod

    scene, _ = cornell_box(resolution=(8, 8))
    acc = traverse.attach_bvh(scene, leaf_size=4, method="sah", min_prims=1)
    info = bvh_mod.debug_info(acc.tri_bvh)
    assert info["n_nodes"] == 2 * info["n_leaves"] - 1
    assert info["n_prims"] == scene.tris.count
    assert 0.0 < info["occupancy"] <= 1.0
    assert info["sah_cost"] > 0.0


def test_sah_beats_or_matches_morton_cost():
    """SAH clusters should not be worse than raw morton clusters on the
    quality metric that predicts traversal rounds."""
    from ba_pathtracing_fur.ops import bvh as bvh_mod
    from ba_pathtracing_fur.ops.intersect import cone_aabbs

    scene, _ = fur_patch(resolution=(8, 8), fibers_per_face=8, fiber_verts=5)
    bmin, bmax = cone_aabbs(scene.cones)
    sah = bvh_mod.debug_info(bvh_mod.build_sah(bmin, bmax, leaf_size=16))
    mor = bvh_mod.debug_info(bvh_mod.build(bmin, bmax, leaf_size=16))
    assert sah["sah_cost"] <= mor["sah_cost"] * 1.05
