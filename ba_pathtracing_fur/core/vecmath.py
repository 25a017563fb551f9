"""Vector math substrate (pure jnp, batched over leading axes).

Wavefront replacement for the glm usage across the reference
(e.g. /root/reference/src/libraries/KIRK/Common/Shading/Bsdf.cpp:87-171,
Math helpers used by the BSDFs). Everything operates on [..., 3] arrays so a
whole wavefront of rays is processed per call; no scalar paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-7
RAY_EPS = 1e-4  # KIRK::cRayEpsilon-equivalent surface offset


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    # floor > 0: sqrt'(0) is inf, which poisons VJPs of masked zero vectors
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-20))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize: returns v/|v| (zero vectors pass through scaled by 0)."""
    n = length(v, keepdims=True)
    return v / jnp.maximum(n, EPS)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """GLSL-convention reflect: incident points TOWARD the surface."""
    return incident - 2.0 * dot(incident, normal, keepdims=True) * normal


def refract(incident: jnp.ndarray, normal: jnp.ndarray, eta) -> jnp.ndarray:
    """GLSL-convention refract; returns 0-vector on total internal reflection.

    Matches glm::refract semantics used throughout the reference BSDFs
    (e.g. Bsdf.cpp:272,340).
    """
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) == jnp.ndim(incident) - 1 else eta
    cos_i = dot(normal, incident, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    k_safe = jnp.maximum(k, 1e-12)  # sqrt'(0)=inf poisons VJPs at exact TIR
    out = eta * incident - (eta * cos_i + jnp.sqrt(k_safe)) * normal
    return jnp.where(tir, 0.0, out)


def faceforward(n: jnp.ndarray, i: jnp.ndarray, nref: jnp.ndarray) -> jnp.ndarray:
    """GLSL faceforward: n if dot(nref, i) < 0 else -n."""
    return jnp.where(dot(nref, i, keepdims=True) < 0.0, n, -n)


def orthonormal_basis(normal: jnp.ndarray):
    """Build (s, t) orthogonal to `normal`.

    Same construction as Light::orthonormalBase
    (/root/reference/src/libraries/KIRK/Common/Light.cpp:112-118).
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = jnp.abs(nx) > jnp.abs(ny)
    inv_xz = 1.0 / jnp.sqrt(jnp.maximum(nx * nx + nz * nz, EPS))
    inv_yz = 1.0 / jnp.sqrt(jnp.maximum(ny * ny + nz * nz, EPS))
    s_a = jnp.stack([-nz * inv_xz, jnp.zeros_like(nx), nx * inv_xz], axis=-1)
    s_b = jnp.stack([jnp.zeros_like(nx), nz * inv_yz, -ny * inv_yz], axis=-1)
    s = jnp.where(use_x[..., None], s_a, s_b)
    t = cross(normal, s)
    return s, t


def local_to_world_normal(local_dir: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Map a z-up local direction into the frame whose z axis is `normal`.

    EXACT Math::localToWorldNormal (Utils/Math.cpp:16-24), the frame the
    reference BSDF samplers build: s = normalize(n.y^2 > n.x^2 ?
    (0, nz, -ny) : (-nz, 0, nx)); t = normalize(cross(n, s)). NOT the same
    as Light::orthonormalBase (orthonormal_basis below) — the branch
    condition differs (y^2 > x^2 vs |x| > |y|), so for normals with
    x == y == 0 the two pick DIFFERENT tangents. This module originally
    used the Light frame here; the independent KIRK-CPU oracle
    (validation/kirk_cpu_oracle.py) caught the divergence on the Cornell
    back wall (r5).
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    dx0 = jnp.stack([jnp.zeros_like(nx), nz, -ny], axis=-1)
    dx1 = jnp.stack([-nz, jnp.zeros_like(nx), nx], axis=-1)
    s = normalize(jnp.where((ny * ny > nx * nx)[..., None], dx0, dx1))
    t = normalize(cross(normal, s))
    return (
        local_dir[..., 0:1] * s
        + local_dir[..., 1:2] * t
        + local_dir[..., 2:3] * normal
    )


def world_to_frame(v: jnp.ndarray, u_ax: jnp.ndarray, v_ax: jnp.ndarray, w_ax: jnp.ndarray) -> jnp.ndarray:
    """Project world vector onto an orthonormal (u, v, w) frame -> local coords."""
    return jnp.stack([dot(v, u_ax), dot(v, v_ax), dot(v, w_ax)], axis=-1)


def frame_to_world(v: jnp.ndarray, u_ax: jnp.ndarray, v_ax: jnp.ndarray, w_ax: jnp.ndarray) -> jnp.ndarray:
    return v[..., 0:1] * u_ax + v[..., 1:2] * v_ax + v[..., 2:3] * w_ax


def rotate_about_axis(v: jnp.ndarray, axis: jnp.ndarray, angle) -> jnp.ndarray:
    """Rodrigues rotation of v about (normalized) axis by angle (radians).

    Replaces the glm::rotate matrix application in the hair BSDFs
    (Bsdf.cpp:498,587,677). NOTE the reference multiplies the row vector on
    the LEFT of the rotation matrix (`vec4(v) * rotate(...)`), which equals
    rotating by -angle; callers pass the already-negated angle to match.
    """
    angle = jnp.asarray(angle)
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    axis = normalize(axis)
    return v * c + cross(axis, v) * s + axis * dot(axis, v, keepdims=True) * (1.0 - c)


def angle_between(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """glm::angle equivalent: acos of clamped dot of normalized vectors."""
    d = dot(normalize(a), normalize(b))
    return jnp.arccos(jnp.clip(d, -1.0 + 1e-7, 1.0 - 1e-7))


def homogeneous_transform_point(mat4: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    return jnp.matmul(ph, mat4.T, precision=jax.lax.Precision.HIGHEST)[..., :3]


def homogeneous_transform_dir(mat4: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    dh = jnp.concatenate([d, jnp.zeros_like(d[..., :1])], axis=-1)
    return jnp.matmul(dh, mat4.T, precision=jax.lax.Precision.HIGHEST)[..., :3]


def normal_matrix(mat4: jnp.ndarray) -> jnp.ndarray:
    """Transpose-inverse 3x3 for transforming normals (Cylinder.cpp:7)."""
    return jnp.linalg.inv(mat4[:3, :3]).T
