"""Differentiable rendering: gradient correctness + fitting convergence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur import diff
from ba_pathtracing_fur.models.pathtracer import RenderConfig
from ba_pathtracing_fur.scene.builtins import cornell_box, fur_patch

CFG = RenderConfig(depth=2, spp=1, ray_chunk=1024)


def test_grad_matches_finite_difference_diffuse():
    scene, camera = cornell_box(resolution=(12, 12))
    key = jax.random.key(0)
    params = diff.make_params(scene)
    target = jnp.zeros((12, 12, 3))
    analytic, numeric = diff.finite_diff_check(
        params, scene, camera, key, target, CFG,
        path=("materials", "diffuse"), index=(0, 0), eps=1e-2)
    assert np.isfinite(analytic) and np.isfinite(numeric)
    assert abs(analytic - numeric) < 0.05 * max(abs(numeric), 1e-3)


def test_grad_flows_to_hair_params():
    scene, camera = fur_patch(resolution=(12, 12), fibers_per_face=6,
                              fiber_verts=4, fiber_radius=0.03)
    key = jax.random.key(1)
    params = diff.make_params(scene)
    target = jnp.zeros((12, 12, 3))
    grads = jax.grad(diff.render_loss)(params, scene, camera, key, target, CFG)
    g_alpha = np.asarray(grads["materials"]["hair_alpha"])
    g_beta = np.asarray(grads["materials"]["hair_beta"])
    assert np.isfinite(g_alpha).all() and np.isfinite(g_beta).all()
    assert (np.abs(g_alpha) + np.abs(g_beta)).max() > 0.0


def test_grad_flows_to_light_color():
    scene, camera = cornell_box(resolution=(12, 12))
    key = jax.random.key(2)
    params = diff.make_params(scene, lights=True)
    target = jnp.zeros((12, 12, 3))
    grads = jax.grad(diff.render_loss)(params, scene, camera, key, target, CFG)
    g = np.asarray(grads["lights"]["color"])
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0


def test_fit_recovers_wall_color():
    scene, camera = cornell_box(resolution=(16, 16))
    key = jax.random.key(3)
    # target: the true render; start: perturbed diffuse
    from ba_pathtracing_fur.models.pathtracer import render_image
    target = render_image(scene, camera, key, CFG)
    mats = scene.materials
    wrong_diffuse = np.array(mats.diffuse)
    wrong_diffuse[1] = (0.2, 0.6, 0.6)
    wrong = scene.replace(materials=mats.replace(diffuse=wrong_diffuse))
    res = diff.fit(wrong, camera, target, CFG, steps=30, lr=5e-2, key=key)
    # stochastic 1-spp gradients: expect a clear decrease, not convergence
    assert res.losses[-1] < res.losses[0] * 0.7
    # red wall drifted back toward red
    rec = np.asarray(res.params["materials"]["diffuse"][1])
    true = np.asarray(mats.diffuse[1])
    assert np.linalg.norm(rec - true) < np.linalg.norm(
        np.array([0.2, 0.6, 0.6]) - true)


def test_grad_with_bvh_attached():
    from ba_pathtracing_fur.ops import traverse
    scene, camera = cornell_box(resolution=(12, 12))
    acc = traverse.attach_bvh(scene, min_prims=1)
    key = jax.random.key(4)
    params = diff.make_params(acc)
    target = jnp.zeros((12, 12, 3))
    grads = jax.grad(diff.render_loss)(params, acc, camera, key, target, CFG)
    g = np.asarray(grads["materials"]["diffuse"])
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
