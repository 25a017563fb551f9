"""DS_Visualizer analog + procedural noise textures."""

import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.ops import traverse, visualize
from ba_pathtracing_fur.scene.builtins import cornell_box
from ba_pathtracing_fur.scene.noise import fbm_noise, noise_texture, value_noise


def test_visualize_structure_shapes_and_overlay():
    scene, camera = cornell_box(resolution=(24, 24))
    acc = traverse.attach_bvh(scene, leaf_size=4, min_prims=1)
    img = visualize.visualize_structure(acc.tri_bvh, camera)
    assert img.shape == (24, 24, 3)
    assert np.isfinite(np.asarray(img)).all()
    # overlay blends onto a base image where boxes are present
    base = jnp.ones((24, 24, 3), jnp.float32) * 0.5
    over = visualize.visualize_structure(acc.tri_bvh, camera, base_image=base)
    assert over.shape == (24, 24, 3)
    assert not np.allclose(np.asarray(over), 0.5)  # something was drawn


def test_visit_count_stats():
    scene, camera = cornell_box(resolution=(16, 16))
    acc = traverse.attach_bvh(scene, leaf_size=4, min_prims=1)
    mean_root, max_root = visualize.visit_count_stats(acc.tri_bvh, camera, level=0)
    mean_leaf, max_leaf = visualize.visit_count_stats(acc.tri_bvh, camera)
    assert max_root <= 1  # single root box
    assert mean_root > 0.3  # a good share of primary rays enter the root
    assert max_leaf >= max_root  # finer level has more boxes to enter
    assert mean_leaf > 0.0


def test_value_noise_deterministic_and_bounded():
    a = value_noise((32, 32), scale=4.0, seed=3)
    b = value_noise((32, 32), scale=4.0, seed=3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    arr = np.asarray(a)
    assert arr.min() >= 0.0 and arr.max() <= 1.0
    assert arr.std() > 0.01  # not constant
    c = value_noise((32, 32), scale=4.0, seed=4)
    assert not np.allclose(np.asarray(c), arr)


def test_fbm_and_texture():
    n = np.asarray(fbm_noise((16, 16), octaves=3))
    assert n.shape == (16, 16) and np.isfinite(n).all()
    t = np.asarray(noise_texture(size=16, color_lo=(0, 0, 0.2), color_hi=(1, 1, 0.8)))
    assert t.shape == (16, 16, 3)
    assert t[..., 2].min() >= 0.2 - 1e-6 and t[..., 2].max() <= 0.8 + 1e-6
