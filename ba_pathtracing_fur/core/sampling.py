"""Sampling + Fresnel helpers (batched jnp).

Wavefront re-expression of the reference's BSDFHelper math
(/root/reference/src/libraries/KIRK/Common/Shading/Bsdf.cpp:79-171) and the
light-sampling helpers (Light.cpp:66-118). All functions take uniform random
numbers as explicit arguments (counter-based RNG upstream) instead of the
reference's shared mt19937 — which was a cross-thread data race (SURVEY §5).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import vecmath as vm

INV_SQRT_2PI = 0.3989422804014327


def normal_gauss_pdf(x, mean, stddev):
    """Gaussian pdf, matching BSDFHelper::normal_gauss_pdf (Bsdf.cpp:79-85)."""
    a = (x - mean) / stddev
    return INV_SQRT_2PI / stddev * jnp.exp(-0.5 * a * a)


def schlick_fresnel(view, normal, ior_in, ior_out):
    """Schlick approximation (Bsdf.cpp:87-93)."""
    r0 = ((ior_in - ior_out) / (ior_in + ior_out)) ** 2
    return r0 + (1.0 - vm.dot(view, normal)) ** 5 * (1.0 - r0)


def dielectric_fresnel(cos_theta, eta_i, eta_t):
    """Full unpolarized dielectric Fresnel (Bsdf.cpp:143-171).

    Negative cos_theta means exiting: indices are swapped. Returns 1.0 on
    total internal reflection.
    """
    cos_i = jnp.clip(cos_theta, -1.0, 1.0)
    entering = cos_i > 0.0
    eta_i_, eta_t_ = (
        jnp.where(entering, eta_i, eta_t),
        jnp.where(entering, eta_t, eta_i),
    )
    cos_i = jnp.abs(cos_i)
    sin_i = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_i * cos_i))
    sin_t = eta_i_ / eta_t_ * sin_i
    tir = sin_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1e-12, 1.0 - sin_t * sin_t))
    def safe(x):
        # sign-preserving zero guard: Bravais "indices" are legitimately
        # negative at grazing (Bsdf.cpp:542-545), so a one-sided floor would
        # blow the ratio up by ~1/eps
        return jnp.where(jnp.abs(x) < vm.EPS, jnp.where(x < 0, -vm.EPS, vm.EPS), x)

    rparl = (eta_t_ * cos_i - eta_i_ * cos_t) / safe(eta_t_ * cos_i + eta_i_ * cos_t)
    rperp = (eta_i_ * cos_i - eta_t_ * cos_t) / safe(eta_i_ * cos_i + eta_t_ * cos_t)
    f = 0.5 * (rparl * rparl + rperp * rperp)
    return jnp.where(tir, 1.0, f)


def concentric_sample_disk(u: jnp.ndarray) -> jnp.ndarray:
    """Concentric disk mapping of u in [0,1]^2 (Bsdf.cpp:95-115). u: [..., 2]."""
    offset = 2.0 * u - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    quarter_pi = jnp.pi / 4.0
    half_pi = jnp.pi / 2.0
    r = jnp.where(use_x, ox, oy)
    safe_ox = jnp.where(ox == 0.0, 1.0, ox)
    safe_oy = jnp.where(oy == 0.0, 1.0, oy)
    theta = jnp.where(use_x, quarter_pi * (oy / safe_ox), half_pi - quarter_pi * (ox / safe_oy))
    d = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, d)


def cosine_sample_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    """Malley's method (Bsdf.cpp:125-132). u: [..., 2] -> [..., 3] z-up."""
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def uniform_sphere_sample(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform unit sphere from u in [0,1]^2 (Bsdf.cpp:134-141). [...,2]->[...,3]."""
    phi = u[..., 1] * 2.0 * jnp.pi
    cos_t = 2.0 * u[..., 0] - 1.0
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def sample_angle(u: jnp.ndarray, max_angle) -> jnp.ndarray:
    """Uniform cone sample about +z with half-angle max_angle (Bsdf.cpp:117-123)."""
    phi = u[..., 0] * 2.0 * jnp.pi
    cos_t = 1.0 - u[..., 1] * (1.0 - jnp.cos(max_angle))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    return jnp.stack([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1)


def sample_disk_about(u: jnp.ndarray, normal: jnp.ndarray, radius) -> jnp.ndarray:
    """Point offset on a disk of `radius` perpendicular to `normal`.

    Mirrors Light::sampleDisk (Light.cpp:94-110): polar r = sqrt(u1).
    """
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * jnp.pi * u[..., 1]
    x = r * jnp.cos(theta) * radius
    y = r * jnp.sin(theta) * radius
    s, t = vm.orthonormal_basis(normal)
    return x[..., None] * s + y[..., None] * t


def cosine_hemisphere_about(u: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction about `normal` (Light.cpp:74-84)."""
    local = cosine_sample_hemisphere(u)
    return vm.local_to_world_normal(local, normal)


def bessel_i0(x):
    """Modified Bessel I0 via its power series (used by d'Eon M term).

    The reference calls MSVC `_j0` (Bsdf.cpp:837); d'Eon's paper actually
    specifies I0. We provide the series-form I0 — smooth, differentiable,
    accurate to ~1e-7 for |x| <= ~12 with 20 terms; larger arguments use the
    asymptotic form.
    """
    x = jnp.asarray(x)
    x2 = 0.25 * x * x
    term = jnp.ones_like(x)
    acc = jnp.ones_like(x)
    for k in range(1, 21):
        term = term * x2 / (k * k)
        acc = acc + term
    # asymptotic branch for large |x| to stay finite
    ax = jnp.abs(x)
    asym = jnp.exp(ax) / jnp.sqrt(jnp.maximum(2.0 * jnp.pi * ax, vm.EPS))
    return jnp.where(ax > 12.0, asym, acc)


def log_bessel_i0(x):
    """log(I0(x)) — numerically safe companion for exponent-heavy M terms."""
    ax = jnp.abs(jnp.asarray(x))
    small = jnp.log(jnp.maximum(bessel_i0(jnp.minimum(ax, 12.0)), 1e-30))
    large = ax - 0.5 * jnp.log(jnp.maximum(2.0 * jnp.pi * ax, vm.EPS))
    return jnp.where(ax > 12.0, large, small)


def poisson_disk_pattern(n: int, seed: int = 0, tries: int = 30):
    """Blue-noise subpixel AA offsets in [0,1)^2 via dart throwing.

    Host-side trace-time constant — the role of the reference's vendored
    PoissonDiskGenerator (Simple_CPU_Raytracer.h:26, used for the
    RTFLAG-gated Whitted AA patterns). Returns a float32 [n,2] numpy array;
    deterministic in (n, seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts: list = []
    min_d2 = (0.75 / np.sqrt(max(n, 1))) ** 2
    budget = tries
    while len(pts) < n:
        c = rng.random(2)
        if all(((c - p) ** 2).sum() >= min_d2 for p in pts):
            pts.append(c)
            budget = tries
        else:
            budget -= 1
            if budget <= 0:  # relax the radius rather than spin forever
                min_d2 *= 0.8
                budget = tries
    return np.asarray(pts, np.float32)
