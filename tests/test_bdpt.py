"""BDPT tests: light-subpath construction, eye connection, camera splat
(lbb_construction.compute / pt_shade.compute:17-201 parity surfaces)."""

import jax
import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.models import bdpt
from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.scene import builtins


def _scene():
    return builtins.cornell_box(resolution=(24, 24))


def test_subpath_buffer_shapes_and_root_vertex():
    scene, _ = _scene()
    sub = bdpt.build_light_subpaths(scene, jax.random.key(0),
                                    samples_per_light=4, n_bounces=3,
                                    ray_chunk=1024)
    p = 4 * scene.lights.count
    assert sub.position.shape == (p, 3, 3)
    assert sub.valid.shape == (p, 3)
    # vertex 0 sits on the light and is always valid with 1/pi throughput
    assert bool(jnp.all(sub.valid[:, 0]))
    np.testing.assert_allclose(np.asarray(sub.hit_color[:, 0]), 1.0 / np.pi,
                               rtol=1e-6)
    # travel distance is non-decreasing along the walk
    tr = np.asarray(sub.travel)
    assert np.all(np.diff(tr, axis=1) >= -1e-5)


def test_subpath_validity_never_resurrects():
    scene, _ = _scene()
    sub = bdpt.build_light_subpaths(scene, jax.random.key(1),
                                    samples_per_light=8, n_bounces=4,
                                    ray_chunk=1024)
    v = np.asarray(sub.valid)
    # once a walk dies it stays dead (monotone mask per path)
    for j in range(2, v.shape[1]):
        assert not np.any(v[:, j] & ~v[:, j - 1])


def test_emit_light_rays_quad_on_surface():
    scene, _ = _scene()
    lights = scene.lights
    n = 256
    idx = jnp.zeros((n,), jnp.int32)
    u1 = jax.random.uniform(jax.random.key(2), (n, 2))
    u2 = jax.random.uniform(jax.random.key(3), (n, 2))
    o, d = bdpt.emit_light_rays(lights, idx, u1, u2)
    assert np.all(np.isfinite(np.asarray(o)))
    # directions are unit and on the emitting side of the quad
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               atol=1e-5)
    kind = int(lights.kind[0])
    if kind == 1:  # quad
        ln = np.asarray(lights.direction[0])
        assert np.all(np.asarray(d) @ ln > -1e-5)


def test_render_bdpt_finite_nonzero():
    scene, camera = _scene()
    cfg = RenderConfig(depth=3, spp=4, ray_chunk=576, bdpt=True,
                       bdpt_bounces=3, bdpt_samples_per_light=4)
    img = np.asarray(render_image(scene, camera, jax.random.key(4), cfg))
    assert np.all(np.isfinite(img))
    assert img.max() > 1e-4
    assert img.min() >= 0.0


def test_render_bdpt_no_splat_also_works():
    scene, camera = _scene()
    cfg = RenderConfig(depth=2, spp=2, ray_chunk=576, bdpt=True,
                       bdpt_bounces=2, bdpt_samples_per_light=2,
                       bdpt_splat=False)
    img = np.asarray(render_image(scene, camera, jax.random.key(5), cfg))
    assert np.all(np.isfinite(img))
