"""On-device fiber generation (builtins.hair_ball(on_device=True)).

The flagship scene is a pure function of (params, seed): the cone pack is
generated by one jit of the threefry draws, and the BVH median split gets
host centroids recomputed closed-form from the SAME draws
(builtins._hair_ball_host_centroids). These tests pin the correctness seam:
the host mirror must describe the actual device pack.
"""

import numpy as np
import jax

from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.ops import intersect as isect, traverse
from ba_pathtracing_fur.scene import builtins


def test_host_centroids_match_device_pack():
    """The closed-form host centroids (what the median split clusters on)
    must equal the actual device pack's cone centroids."""
    sc, _ = builtins.hair_ball(resolution=(32, 32), n_fibers=500,
                               on_device=True)
    hint = dict(builtins.LAST_HAIRBALL_GEN)
    cent_pack = np.asarray(isect.cone_centroids(sc.cones))
    np.testing.assert_allclose(hint["centroids"], cent_pack, atol=1e-5)


def test_device_gen_deterministic():
    """Same seed -> identical pack (threefry is counter-based)."""
    a, _ = builtins.hair_ball(resolution=(32, 32), n_fibers=200,
                              on_device=True, seed=3)
    b, _ = builtins.hair_ball(resolution=(32, 32), n_fibers=200,
                              on_device=True, seed=3)
    for la, lb in zip(jax.tree.leaves(a.cones), jax.tree.leaves(b.cones)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    c, _ = builtins.hair_ball(resolution=(32, 32), n_fibers=200,
                              on_device=True, seed=4)
    assert not np.allclose(np.asarray(a.cones.base), np.asarray(c.cones.base))


def test_device_gen_attach_hint_and_render():
    """attach_bvh(cone_split_hint=...) builds on device without pulling the
    pack, and the scene renders finite/non-trivial through the public API."""
    sc, cam = builtins.hair_ball(resolution=(48, 48), n_fibers=1500,
                                 on_device=True)
    hint = dict(builtins.LAST_HAIRBALL_GEN)
    sc = traverse.attach_bvh(sc, method="median", cone_split_hint=hint,
                             min_prims=1024)
    assert sc.cone_bvh is not None
    assert traverse.LAST_BUILD_STATS.get("split") is not None
    cfg = RenderConfig(depth=3, spp=2, ray_chunk=2304, compact=False)
    img = np.asarray(render_image(sc, cam, jax.random.key(0), cfg))
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01
    assert img.std() > 1e-4
