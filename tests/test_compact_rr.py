"""Stream compaction (pt_sortHits analog) + Russian roulette tests."""

import jax
import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.ops import compact
from ba_pathtracing_fur.scene import builtins


def test_compaction_permutation_stable():
    alive = jnp.array([True, False, True, True, False, False, True])
    perm, n = compact.compaction_permutation(alive)
    assert int(n) == 4
    np.testing.assert_array_equal(np.asarray(perm), [0, 2, 3, 6, 1, 4, 5])
    inv = compact.invert_permutation(perm)
    np.testing.assert_array_equal(np.asarray(perm[inv]), np.arange(7))


def test_compaction_gather_pytree_roundtrip():
    key = jax.random.key(0)
    alive = jax.random.uniform(key, (512,)) > 0.6
    data = {"o": jax.random.normal(key, (512, 3)),
            "t": jax.random.normal(key, (512,))}
    perm, n = compact.compaction_permutation(alive)
    packed = compact.gather_pytree(data, perm)
    # front of the packed buffer is exactly the alive rays, in order
    n = int(n)
    np.testing.assert_allclose(np.asarray(packed["o"][:n]),
                               np.asarray(data["o"][alive]))
    inv = compact.invert_permutation(perm)
    restored = compact.gather_pytree(packed, inv)
    np.testing.assert_allclose(np.asarray(restored["t"]), np.asarray(data["t"]))


def test_compaction_all_dead_and_all_alive():
    for alive in (jnp.zeros((16,), bool), jnp.ones((16,), bool)):
        perm, n = compact.compaction_permutation(alive)
        np.testing.assert_array_equal(np.sort(np.asarray(perm)), np.arange(16))
        assert int(n) == int(alive.sum())


def test_rr_unbiased_vs_plain():
    """RR render mean must agree with the no-cutoff estimator within noise
    on a bright diffuse scene (RR replaces the biased 0.01 cutoff, so
    compare against rr_start beyond depth = plain estimator)."""
    scene, camera = builtins.cornell_box(resolution=(24, 24))
    key = jax.random.key(5)
    base = RenderConfig(depth=4, spp=48, ray_chunk=576, mis=True,
                        rr=True, rr_start=99)  # RR never fires
    rr = base._replace(rr_start=1)
    img_a = np.asarray(render_image(scene, camera, key, base))
    img_b = np.asarray(render_image(scene, camera, key, rr))
    assert np.all(np.isfinite(img_b))
    ma, mb = img_a.mean(), img_b.mean()
    assert abs(ma - mb) / ma < 0.12, (ma, mb)
