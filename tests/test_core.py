"""Core math / sampling / camera unit tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.core import camera as cam_mod, rng, sampling as sp, vecmath as vm


def test_reflect_refract_roundtrip():
    n = jnp.array([[0.0, 1.0, 0.0]])
    i = vm.normalize(jnp.array([[1.0, -1.0, 0.0]]))
    r = vm.reflect(i, n)
    np.testing.assert_allclose(np.asarray(r), [[0.70710677, 0.70710677, 0.0]], atol=1e-6)
    # refraction at eta=1 passes straight through
    t = vm.refract(i, n, 1.0)
    np.testing.assert_allclose(np.asarray(t), np.asarray(i), atol=1e-6)
    # total internal reflection -> zero vector
    t2 = vm.refract(vm.normalize(jnp.array([[1.0, -0.05, 0.0]])), n, 1.8)
    assert float(vm.dot(t2, t2)[0]) == 0.0


def test_faceforward_matches_glsl():
    n = jnp.array([[0.0, 1.0, 0.0]])
    i_toward = jnp.array([[0.0, -1.0, 0.0]])
    out = vm.faceforward(n, i_toward, n)
    np.testing.assert_allclose(np.asarray(out), np.asarray(n))
    out2 = vm.faceforward(n, -i_toward, n)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(-n))


def test_dielectric_fresnel_limits():
    # normal incidence, glass: ((1.5-1)/(1.5+1))^2 = 0.04
    f = sp.dielectric_fresnel(jnp.array([1.0]), jnp.array([1.0]), jnp.array([1.5]))
    np.testing.assert_allclose(float(f[0]), 0.04, atol=1e-4)
    # grazing -> 1
    f = sp.dielectric_fresnel(jnp.array([0.001]), jnp.array([1.0]), jnp.array([1.5]))
    assert float(f[0]) > 0.9
    # TIR from inside
    f = sp.dielectric_fresnel(jnp.array([-0.1]), jnp.array([1.0]), jnp.array([1.5]))
    np.testing.assert_allclose(float(f[0]), 1.0)


def test_cosine_hemisphere_distribution():
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (20000, 2))
    d = sp.cosine_sample_hemisphere(u)
    assert float(jnp.min(d[:, 2])) >= 0.0
    lens = np.asarray(vm.length(d))
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)
    # E[cos theta] for pdf cos/pi is 2/3
    np.testing.assert_allclose(float(jnp.mean(d[:, 2])), 2.0 / 3.0, atol=0.01)


def test_uniform_sphere_mean_zero():
    u = jax.random.uniform(jax.random.PRNGKey(1), (20000, 2))
    d = sp.uniform_sphere_sample(u)
    np.testing.assert_allclose(np.asarray(jnp.mean(d, axis=0)), 0.0, atol=0.02)


def test_rotate_about_axis():
    v = jnp.array([[1.0, 0.0, 0.0]])
    axis = jnp.array([[0.0, 0.0, 1.0]])
    out = vm.rotate_about_axis(v, axis, jnp.pi / 2)
    np.testing.assert_allclose(np.asarray(out), [[0.0, 1.0, 0.0]], atol=1e-6)


def test_camera_fov_and_center_ray():
    cam = cam_mod.make_camera(position=(0, 0, 0), look_at=(0, 0, -1),
                              resolution=(64, 64))
    px, py = cam_mod.pixel_grid(cam.resolution)
    o, d = cam_mod.rays_from_pixels(cam, px, py, jnp.full((64 * 64, 2), 0.5))
    # central ray looks straight down -z
    center = 32 * 64 + 32
    dn = np.asarray(vm.normalize(d))[center]
    assert dn[2] < -0.99
    np.testing.assert_allclose(np.asarray(o)[0], [0, 0, 0], atol=1e-6)


def test_rng_reproducible_and_distinct():
    key = jax.random.PRNGKey(7)
    k1 = rng.pixel_keys(key, 128, 0)
    k2 = rng.pixel_keys(key, 128, 0)
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    u0 = rng.bounce_uniform(k1, 0, 2)
    u1 = rng.bounce_uniform(k1, 1, 2)
    assert not np.allclose(np.asarray(u0), np.asarray(u1))
    assert np.asarray(u0).min() >= 0.0 and np.asarray(u0).max() < 1.0


def test_bessel_j0_known_values():
    from ba_pathtracing_fur.models.fur import bessel_j0
    xs = jnp.array([0.0, 1.0, 2.4048255577, 5.0, 10.0])
    ref = np.array([1.0, 0.7651976866, 0.0, -0.1775967713, -0.2459357645])
    np.testing.assert_allclose(np.asarray(bessel_j0(xs)), ref, atol=2e-6)


def test_radical_inverse_known_values():
    """radicalInverse_VdC (inc_random.compute:34-42): bit-reversal/2^32."""
    got = np.asarray(rng.radical_inverse_vdc(jnp.arange(8, dtype=jnp.uint32)))
    ref = np.array([0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])
    np.testing.assert_allclose(got, ref, atol=1e-7)


def test_hammersley_qmc_jitter():
    pts = np.asarray(rng.hammersley2d(jnp.arange(4, dtype=jnp.uint32), 0.25))
    np.testing.assert_allclose(pts[:, 0], [0.0, 0.25, 0.5, 0.75], atol=1e-7)
    # Cranley-Patterson rotation: in [0,1)^2, same rotation for the same
    # pixel across samples, different across pixels
    key = jax.random.key(0)
    ids = jnp.arange(16)
    a = np.asarray(rng.qmc_jitter(key, ids, 0, 8))
    b = np.asarray(rng.qmc_jitter(key, ids, 1, 8))
    assert a.shape == (16, 2) and (a >= 0).all() and (a < 1).all()
    # delta between samples is the same Hammersley offset for every pixel
    d = np.mod(b - a, 1.0)
    np.testing.assert_allclose(d, np.broadcast_to(d[:1], d.shape), atol=1e-6)
    assert not np.allclose(a[0], a[1])  # pixels decorrelated
