"""End-to-end wavefront path tracer tests (small renders on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.models import pathtracer as pt
from ba_pathtracing_fur.scene import builtins


def _render(scene, cam, spp=4, depth=3):
    cfg = pt.RenderConfig(depth=depth, spp=spp, ray_chunk=4096)
    img = pt.render_image(scene, cam, jax.random.PRNGKey(0), cfg)
    return np.asarray(img)


def test_cornell_smoke():
    scene, cam = builtins.cornell_box(resolution=(48, 48))
    img = _render(scene, cam, spp=4, depth=3)
    assert img.shape == (48, 48, 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01  # something is lit
    # left half should be redder than the right half (red vs green wall)
    left = img[:, :10].mean(axis=(0, 1))
    right = img[:, -10:].mean(axis=(0, 1))
    assert left[0] / max(left[1], 1e-6) > right[0] / max(right[1], 1e-6)


def test_cornell_deterministic():
    scene, cam = builtins.cornell_box(resolution=(32, 32))
    a = _render(scene, cam, spp=2, depth=2)
    b = _render(scene, cam, spp=2, depth=2)
    np.testing.assert_array_equal(a, b)


def test_cornell_converges_with_spp():
    scene, cam = builtins.cornell_box(resolution=(32, 32))
    ref = _render(scene, cam, spp=64, depth=3)
    lo = _render(scene, cam, spp=4, depth=3)
    hi = _render(scene, cam, spp=32, depth=3)
    err_lo = np.mean((lo - ref) ** 2)
    err_hi = np.mean((hi - ref) ** 2)
    assert err_hi < err_lo


def test_progressive_matches_batch():
    scene, cam = builtins.cornell_box(resolution=(24, 24))
    cfg = pt.RenderConfig(depth=2, spp=3, ray_chunk=4096)
    batch = np.asarray(pt.render_image(scene, cam, jax.random.PRNGKey(0), cfg))
    last = None
    for _, img in pt.render_progressive(scene, cam, jax.random.PRNGKey(0), cfg):
        last = np.asarray(img)
    np.testing.assert_allclose(last, batch, atol=1e-5)


def test_glossy_variant_runs():
    scene, cam = builtins.cornell_box(resolution=(32, 32), variant="glossy")
    img = _render(scene, cam, spp=4, depth=4)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01


def test_fur_patch_smoke():
    scene, cam = builtins.fur_patch(resolution=(32, 32), fibers_per_face=3,
                                    fiber_verts=5)
    assert scene.cones.count == 2 * 3 * 4  # 2 faces * 3 fibers * (5-1) segments
    img = _render(scene, cam, spp=2, depth=3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0
