"""Layout-agnostic per-bounce shading core — the body of the fused bounce
(reference model: the GPU pipeline's single shade kernel,
/root/reference/src/shaders/compute/Pathtracer/pt_shade.compute:99-287).

It expresses the shading math over vectors as TRIPLES of same-shape scalar
arrays (`V3`) instead of [R,3] arrays, so the same code runs:
  * under plain XLA with [R]-shaped components (ops/pallas/shade.
    shade_bounce, the fused shade stage), and
  * inside the level-2 Pallas kernel with [BLOCK]-shaped components, one
    ray per thread (ops/pallas/shade.shade_bounce_full).

The math transcribes models/bsdf.py, models/fur.py, models/shading.py and
the light intersections of ops/intersect.py one-to-one (same citations,
same quirks, same epsilons); purely elementwise helpers (dielectric
fresnel, gaussian pdf, bessel J0, d'Eon M/detector) are imported from
those modules directly — one definition, both layouts. Equality with the
unfused trace_bounce is pinned by tests/test_fused_shade.py and
tests/test_full_kernel.py.

No axis reductions and no gathers: lights are consumed via a STATIC python
loop over per-light scalar parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.sampling import dielectric_fresnel, normal_gauss_pdf
from .fur import bessel_j0
from ..scene.types import (
    BSDF_DEON_HAIR, BSDF_EMISSION, BSDF_GLASS, BSDF_GLOSSY, BSDF_LAMBERT,
    BSDF_LAMBERT_TRANSMISSION, BSDF_MARSCHNER_HAIR, BSDF_MILK_GLASS,
    BSDF_SPECULAR_REFLECTION, BSDF_SPECULAR_TRANSMISSION, BSDF_TRANSPARENT,
    LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, LIGHT_SUN,
    MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_EMISSIVE_BOUNCE, MATFLAG_SPECULAR_BOUNCE,
    MATFLAG_TRANSPARENT_BOUNCE,
    SHADER_MARSCHNER_HAIR,
)
from .fur import _bravais, _clip1, _safe_div

EPS = 1e-7  # vm.EPS
_EPS = 1e-6  # fur._EPS
INF = 3.4e38
TRI_EPS = 1.1920929e-7


# ---------------------------------------------------------------------------
# Software inverse trig: Cephes-style f32 forms (~1 ulp class accuracy —
# below the f32 noise the shading math already tolerates). Used by BOTH
# layouts so the XLA stage stays op-identical to the kernel.
# ---------------------------------------------------------------------------

_TAN_3PI_8 = 2.414213562373095
_TAN_PI_8 = 0.4142135623730950


def atan_(x):
    """Cephes atanf: range-reduced polynomial."""
    ax = jnp.abs(x)
    big = ax > _TAN_3PI_8
    mid = (ax > _TAN_PI_8) & ~big
    y0 = jnp.where(big, jnp.pi / 2.0, jnp.where(mid, jnp.pi / 4.0, 0.0))
    safe = jnp.where(ax == 0.0, 1.0, ax)
    xr = jnp.where(big, -1.0 / safe,
                   jnp.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    z = xr * xr
    p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
         + 1.99777106478e-1) * z - 3.33329491539e-1
    r = y0 + p * z * xr + xr
    return jnp.where(x < 0.0, -r, r)


def atan2_(y, x):
    """glibc-convention atan2 from atan_ with quadrant fixup."""
    safe_x = jnp.where(x == 0.0, 1.0, x)
    base = atan_(y / safe_x)
    r = jnp.where(x > 0.0, base,
        jnp.where(y >= 0.0, base + jnp.pi, base - jnp.pi))
    r = jnp.where(x == 0.0,
                  jnp.where(y > 0.0, jnp.pi / 2.0,
                            jnp.where(y < 0.0, -jnp.pi / 2.0, 0.0)),
                  r)
    return r


def asin_(x):
    xc = jnp.clip(x, -1.0, 1.0)
    return atan2_(xc, jnp.sqrt(jnp.maximum(1.0 - xc * xc, 0.0)))


def acos_(x):
    xc = jnp.clip(x, -1.0, 1.0)
    return atan2_(jnp.sqrt(jnp.maximum(1.0 - xc * xc, 0.0)), xc)


def _deon_M(v, theta_i, theta_r, radians_quirk):
    """fur._deon_M with log1p replaced by log(1+x) (op-identical in both
    layouts)."""
    v_safe = jnp.maximum(v, _EPS)
    if radians_quirk:
        x = jnp.radians(1.0 / v_safe)
        scale = jnp.degrees(v_safe)
    else:
        x = 1.0 / v_safe
        scale = v_safe
    s = jnp.sin(-theta_i) * jnp.sin(theta_r) / scale
    x_pos = jnp.maximum(x, _EPS)
    log_m = -x_pos - jnp.log(jnp.maximum(1.0 - jnp.exp(-2.0 * x_pos),
                                         1e-30)) \
        - jnp.log(v_safe) + s
    bes = bessel_j0(jnp.cos(-theta_i) * jnp.cos(theta_r) / scale)
    return jnp.exp(jnp.minimum(log_m, 80.0)) * bes


def _deon_detector(phi, stddev_deg):
    """fur._deon_detector twin (pure exp)."""
    acc = 0.0
    for k in range(-10, 11):
        acc = acc + normal_gauss_pdf(phi - 2.0 * jnp.pi * k, 0.0, stddev_deg)
    return acc


# ---------------------------------------------------------------------------
# V3: vectors as component triples (any array shape)
# ---------------------------------------------------------------------------

class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def v3_full(shape, val):
    a = jnp.full(shape, val, jnp.float32)
    return V3(a, a, a)


def dot3(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length3(v: V3):
    return jnp.sqrt(jnp.maximum(dot3(v, v), 1e-20))


def normalize3(v: V3) -> V3:
    return v * (1.0 / jnp.maximum(length3(v), EPS))


def where3(m, a, b) -> V3:
    if not isinstance(a, V3):
        a = V3(jnp.asarray(a, jnp.float32), jnp.asarray(a, jnp.float32),
               jnp.asarray(a, jnp.float32))
    if not isinstance(b, V3):
        b = V3(jnp.asarray(b, jnp.float32), jnp.asarray(b, jnp.float32),
               jnp.asarray(b, jnp.float32))
    return V3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y),
              jnp.where(m, a.z, b.z))


def reflect3(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot3(i, n))


def refract3(i: V3, n: V3, eta) -> V3:
    """vm.refract twin (glm::refract; 0-vector on TIR)."""
    cos_i = dot3(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    out = i * eta - n * (eta * cos_i + jnp.sqrt(jnp.maximum(k, 1e-12)))
    return where3(tir, 0.0, out)


def faceforward3(n: V3, i: V3, nref: V3) -> V3:
    return where3(dot3(nref, i) < 0.0, n, -n)


def rotate3(v: V3, axis: V3, angle) -> V3:
    """vm.rotate_about_axis twin (Rodrigues)."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    a = normalize3(axis)
    return v * c + cross3(a, v) * s + a * (dot3(a, v) * (1.0 - c))


def angle_between3(a: V3, b: V3):
    d = dot3(normalize3(a), normalize3(b))
    return acos_(jnp.clip(d, -1.0 + 1e-7, 1.0 - 1e-7))


def local_to_world_normal3(lx, ly, lz, n: V3) -> V3:
    """Math::localToWorldNormal twin (vm.local_to_world_normal)."""
    zero = jnp.zeros_like(n.x)
    pick = n.y * n.y > n.x * n.x
    sx = jnp.where(pick, zero, -n.z)
    sy = jnp.where(pick, n.z, zero)
    sz = jnp.where(pick, -n.y, n.x)
    s = normalize3(V3(sx, sy, sz))
    t = normalize3(cross3(n, s))
    return s * lx + t * ly + n * lz


def orthonormal_basis3(n: V3):
    """vm.orthonormal_basis twin (Light::orthonormalBase)."""
    use_x = jnp.abs(n.x) > jnp.abs(n.y)
    inv_xz = 1.0 / jnp.sqrt(jnp.maximum(n.x * n.x + n.z * n.z, EPS))
    inv_yz = 1.0 / jnp.sqrt(jnp.maximum(n.y * n.y + n.z * n.z, EPS))
    zero = jnp.zeros_like(n.x)
    s = V3(jnp.where(use_x, -n.z * inv_xz, zero),
           jnp.where(use_x, zero, n.z * inv_yz),
           jnp.where(use_x, n.x * inv_xz, -n.y * inv_yz))
    t = cross3(n, s)
    return s, t


def concentric_disk3(u1, u2):
    """sp.concentric_sample_disk twin -> (dx, dy)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    quarter_pi = jnp.pi / 4.0
    half_pi = jnp.pi / 2.0
    r = jnp.where(use_x, ox, oy)
    safe_ox = jnp.where(ox == 0.0, 1.0, ox)
    safe_oy = jnp.where(oy == 0.0, 1.0, oy)
    theta = jnp.where(use_x, quarter_pi * (oy / safe_ox),
                      half_pi - quarter_pi * (ox / safe_oy))
    dx = r * jnp.cos(theta)
    dy = r * jnp.sin(theta)
    return jnp.where(zero, 0.0, dx), jnp.where(zero, 0.0, dy)


def cosine_hemisphere3(u1, u2):
    dx, dy = concentric_disk3(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - dx * dx - dy * dy))
    return dx, dy, z


def sample_angle3(u1, u2, max_angle):
    """sp.sample_angle twin (uniform cone about +z)."""
    phi = u1 * 2.0 * jnp.pi
    cos_t = 1.0 - u2 * (1.0 - jnp.cos(max_angle))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    return jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t


def uniform_sphere3(u1, u2) -> V3:
    phi = u2 * 2.0 * jnp.pi
    cos_t = 2.0 * u1 - 1.0
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    return V3(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t)


# ---------------------------------------------------------------------------
# Core material / light row types
# ---------------------------------------------------------------------------

class CoreMat(NamedTuple):
    """Per-ray gathered material (models/bsdf.MatParams in V3 form)."""

    diffuse: V3
    specular: V3
    volume: V3
    emission: V3
    ior: jnp.ndarray
    transparency: jnp.ndarray
    reflectivity: jnp.ndarray
    roughness: jnp.ndarray
    bsdf_id: jnp.ndarray  # int32
    shader_id: jnp.ndarray  # int32
    hair_alpha: jnp.ndarray
    hair_beta: jnp.ndarray


class CoreLight(NamedTuple):
    """ONE light's parameters as 0-d scalars (static-loop consumption)."""

    kind: jnp.ndarray  # int32 scalar
    color: V3
    position: V3
    direction: V3
    radius: jnp.ndarray
    const_att: jnp.ndarray
    lin_att: jnp.ndarray
    quad_att: jnp.ndarray
    v0: V3  # quad corners
    v1: V3
    v2: V3
    v3: V3
    inner_angle: jnp.ndarray
    outer_angle: jnp.ndarray
    area: jnp.ndarray  # precomputed quad bilinear-patch area (MIS)


class CoreCfg(NamedTuple):
    """STATIC configuration (python values only — baked into the trace)."""

    n_lights: int
    mis: bool = False
    rr: bool = False
    has_hair: bool = False
    hair_p_random: bool = False
    clamp_throughput: float = 1e4
    bsdfs_present: tuple = ()


class CoreOut(NamedTuple):
    origin: V3
    direction: V3
    radiance: V3
    color: V3  # WITHOUT the direct term — add direct_rgb after occlusion
    flags: jnp.ndarray
    theta_i: jnp.ndarray
    prev_pdf: jnp.ndarray
    shadow_o: V3
    shadow_d: V3  # normalized
    shadow_tmax: jnp.ndarray  # 0 on lanes with no shadow ray
    direct_rgb: V3  # pre-occlusion NEE contribution x throughput x masks


# ---------------------------------------------------------------------------
# Light math (static per-light; models/shading.py + ops/intersect.py twins)
# ---------------------------------------------------------------------------

def _distance_attenuation(li: CoreLight, dist):
    use = (li.const_att > 0.0) | ((li.lin_att > 0.0) & (li.quad_att > 0.0))
    denom = jnp.maximum(
        li.const_att + li.lin_att * dist + li.quad_att * dist * dist, 1e-12)
    return jnp.where(use, 1.0 / denom, 1.0)


def _tri_t3(o: V3, d: V3, a: V3, b: V3, c: V3):
    """Möller–Trumbore (ops/intersect._tri_t twin). Returns (t, ok)."""
    e1 = b - a
    e2 = c - a
    p = cross3(d, e2)
    det = dot3(e1, p)
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tv = o - a
    u = dot3(tv, p) * inv_det
    q = cross3(tv, e1)
    v = dot3(d, q) * inv_det
    t = dot3(e2, q) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > TRI_EPS)
    return t, ok


def light_hit3(o: V3, d: V3, li: CoreLight):
    """One light's analytic intersection (light_hit_grid twin) -> (t, ok)."""
    kind = li.kind
    # point: sphere (chosen root -0.5*(b+sqrt)/a, facing precondition)
    oc = o - li.position
    facing_away = dot3(d, oc) > 0.0
    a = dot3(d, d)
    b = 2.0 * dot3(d, oc)
    c = (dot3(li.position, li.position) + dot3(o, o)
         - 2.0 * dot3(o, li.position) - li.radius * li.radius)
    disc = b * b - 4.0 * a * c
    point_ok = (li.radius * li.radius > 0.0) & (~facing_away) & (disc >= 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t_point = -0.5 * (b + sq) / jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)

    # quad: (v0,v1,v3) then (v2,v3,v1); second overwrites (|| order)
    tq1, ok1 = _tri_t3(o, d, li.v0, li.v1, li.v3)
    tq2, ok2 = _tri_t3(o, d, li.v2, li.v3, li.v1)
    t_quad = jnp.where(ok2, tq2, tq1)
    quad_ok = ok1 | ok2

    # spot: disk about position perpendicular to direction
    s_ax, t_ax = orthonormal_basis3(li.direction)
    p = cross3(d, t_ax)
    det = dot3(s_ax, p)
    okd = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(okd, det, 1.0)
    tv = o - li.position
    uu = dot3(tv, p) * inv_det
    q = cross3(tv, s_ax)
    vv = dot3(d, q) * inv_det
    t_spot = dot3(t_ax, q) * inv_det
    spot_ok = okd & (uu * uu + vv * vv <= li.radius * li.radius) \
        & (t_spot > TRI_EPS) & (li.radius > 0.0)

    t = jnp.where(kind == LIGHT_POINT, t_point,
        jnp.where(kind == LIGHT_QUAD, t_quad,
        jnp.where(kind == LIGHT_SPOT, t_spot, INF)))
    # boolean-select via masks, not jnp.where on booleans
    ok = ((kind == LIGHT_POINT) & point_ok) \
        | ((kind == LIGHT_QUAD) & quad_ok) \
        | ((kind == LIGHT_SPOT) & spot_ok)
    return jnp.where(ok, t, INF), ok


def light_emitted3(li: CoreLight, ray_dir: V3) -> V3:
    """light_emitted_radiance twin (sampleLightSource per kind)."""
    cdiv = jnp.where(li.const_att > 0.0, li.const_att, 1.0)
    facing = dot3(normalize3(-ray_dir), li.direction) >= 0.0
    inv_pi = 1.0 / jnp.pi
    rad_point = li.color * (inv_pi / cdiv)
    rad_dirlike = where3(facing, li.color, 0.0) * (inv_pi / cdiv)
    return where3(li.kind == LIGHT_POINT, rad_point,
           where3(li.kind == LIGHT_SUN, li.color, rad_dirlike))


def light_sample_dir3(li: CoreLight, pos: V3, u1, u2):
    """sample_light_dir twin -> (target V3, attenuation)."""
    # point
    sphere_pt = uniform_sphere3(u1, u2)
    p_pos = li.position + sphere_pt * li.radius
    dir0 = normalize3(li.position - pos)
    dd_point = jnp.clip(dot3(sphere_pt, -dir0), 0.0, 1.0)
    att_point = dd_point * _distance_attenuation(li, length3(p_pos - pos))

    # quad bilinear
    x1 = li.v0 + (li.v1 - li.v0) * u1
    x2 = li.v3 + (li.v2 - li.v3) * u1
    q_pos = x1 + (x2 - x1) * u2
    q_dir = q_pos - pos
    dd_quad = jnp.clip(dot3(normalize3(-q_dir), li.direction), 0.0, 1.0)
    att_quad = dd_quad * _distance_attenuation(li, length3(q_dir))

    # spot: disk offset + quartic angular falloff
    r = jnp.sqrt(u1) * li.radius
    theta = 2.0 * jnp.pi * u2
    s_ax, t_ax = orthonormal_basis3(li.direction)
    disk = s_ax * (r * jnp.cos(theta)) + t_ax * (r * jnp.sin(theta))
    s_pos = li.position + disk
    s_dir = s_pos - pos
    ang = jnp.degrees(acos_(jnp.clip(
        dot3(normalize3(-s_dir), li.direction), -1.0 + 1e-7, 1.0 - 1e-7)))
    delta = 1.0 - jnp.clip(
        (ang - li.inner_angle)
        / jnp.maximum(li.outer_angle - li.inner_angle, 1e-6), 0.0, 1.0)
    att_spot = delta ** 4 * _distance_attenuation(li, length3(s_dir))

    # sun at 1e16
    sun_pt = uniform_sphere3(u1, u2) * li.radius - li.direction
    sun_pos = normalize3(sun_pt) * 1e16
    att_sun = jnp.ones_like(att_point)

    target = where3(li.kind == LIGHT_POINT, p_pos,
             where3(li.kind == LIGHT_QUAD, q_pos,
             where3(li.kind == LIGHT_SPOT, s_pos, sun_pos)))
    att = jnp.where(li.kind == LIGHT_POINT, att_point,
          jnp.where(li.kind == LIGHT_QUAD, att_quad,
          jnp.where(li.kind == LIGHT_SPOT, att_spot, att_sun)))
    return target, att


def light_solid_angle_pdf3(li: CoreLight, n_lights: int, direction: V3, dist):
    """light_solid_angle_pdf twin (incl. the uniform 1/N pick)."""
    d = normalize3(direction)
    cos_l = jnp.abs(dot3(d, li.direction))
    p_quad = dist * dist / (jnp.maximum(li.area, 1e-12)
                            * jnp.maximum(cos_l, 1e-4))
    r = jnp.maximum(li.radius, 1e-6)
    p_point = dist * dist / (jnp.pi * r * r)
    p = jnp.where(li.kind == LIGHT_QUAD, p_quad,
        jnp.where(li.kind == LIGHT_POINT, p_point, 0.0))
    return p / n_lights


def power_heuristic(pf, pg):
    pf2 = pf * pf
    return pf2 / jnp.maximum(pf2 + pg * pg, 1e-20)


# ---------------------------------------------------------------------------
# Surface BSDFs (models/bsdf.py twins)
# ---------------------------------------------------------------------------

class CoreBsdf(NamedTuple):
    refl: V3
    wo: V3
    pdf: jnp.ndarray
    flags: jnp.ndarray


def _abs_dot_safe3(a, b):
    return jnp.maximum(jnp.abs(dot3(a, b)), EPS)


def _b_lambert(mp, wi, n, u1, u2, flags):
    entering = dot3(wi, n) > 0.0
    lx, ly, lz = cosine_hemisphere3(u1, u2)
    sgn = jnp.where(entering, 1.0, -1.0)
    wo = local_to_world_normal3(lx * sgn, ly * sgn, lz * sgn, n)
    pdf = jnp.abs(dot3(wo, n)) / jnp.pi
    refl = where3(pdf == 0.0, 0.0, mp.diffuse * (1.0 / jnp.pi))
    return CoreBsdf(refl, wo, pdf, jnp.zeros_like(flags))


def _b_specular_reflection(mp, wi, n, u1, u2, flags):
    nf = faceforward3(n, -wi, n)
    wo = reflect3(-wi, nf)
    refl = mp.specular * (1.0 / _abs_dot_safe3(wo, n))
    return CoreBsdf(refl, wo, jnp.ones_like(u1),
                    flags | MATFLAG_SPECULAR_BOUNCE)


def _b_specular_transmission(mp, wi, n, u1, u2, flags):
    entering = dot3(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = dielectric_fresnel(jnp.abs(dot3(wi, n)), eta_i, eta_t)
    nf = faceforward3(n, -wi, n)
    wo = refract3(normalize3(-wi), nf, eta_i / eta_t)
    refracted = dot3(wo, wo) > 0.0
    ft = mp.volume * ((1.0 - fresnel) * (eta_i * eta_i) / (eta_t * eta_t))
    refl = where3(refracted, ft * (1.0 / _abs_dot_safe3(wo, n)), 0.0)
    nfl = flags | MATFLAG_SPECULAR_BOUNCE \
        | jnp.where(refracted, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return CoreBsdf(refl, wo, jnp.ones_like(u1), nfl)


def _b_glossy(mp, wi, n, u1, u2, flags):
    nf = faceforward3(n, -wi, n)
    reflected = reflect3(-wi, nf)
    rad = jnp.radians(180.0 - (1.0 - mp.roughness) * 180.0)
    sx, sy, sz = sample_angle3(u1, u2, rad)
    wo = local_to_world_normal3(sx, sy, sz, reflected)
    flip = dot3(wo, nf) < 0.0
    wo_f = local_to_world_normal3(-sx, -sy, sz, reflected)
    wo = where3(flip, wo_f, wo)
    refl = mp.specular * (1.0 / _abs_dot_safe3(wo, n))
    return CoreBsdf(refl, wo, jnp.ones_like(u1),
                    flags | MATFLAG_SPECULAR_BOUNCE)


def _b_glass(mp, wi, n, u1, u2, flags):
    win = normalize3(wi)
    entering = dot3(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = dielectric_fresnel(jnp.abs(dot3(win, n)), eta_i, eta_t)
    nf = faceforward3(n, -win, n)
    refr = refract3(-win, nf, eta_i / eta_t)
    can_refract = dot3(refr, refr) > 0.0
    choose_t = can_refract & (u2 > fresnel)
    ft = mp.volume * ((1.0 - fresnel) * (eta_i * eta_i) / (eta_t * eta_t))
    refl_t = ft * (1.0 / _abs_dot_safe3(refr, n))
    wo_r = reflect3(-win, nf)
    refl_r = mp.specular * (fresnel / _abs_dot_safe3(wo_r, n))
    wo = where3(choose_t, refr, wo_r)
    refl = where3(choose_t, refl_t, refl_r)
    pdf = jnp.where(choose_t, 1.0 - fresnel, fresnel)
    nfl = flags | MATFLAG_SPECULAR_BOUNCE \
        | jnp.where(choose_t, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return CoreBsdf(refl, wo, pdf, nfl)


def _b_milk_glass(mp, wi, n, u1, u2, flags):
    win = normalize3(wi)
    entering = dot3(wi, n) > 0.0
    eta_i = jnp.where(entering, 1.0, mp.ior)
    eta_t = jnp.where(entering, mp.ior, 1.0)
    fresnel = dielectric_fresnel(jnp.abs(dot3(win, n)), eta_i, eta_t)
    nf = faceforward3(n, -win, n)
    refr = refract3(-win, nf, eta_i / eta_t)
    can_refract = dot3(refr, refr) > 0.0
    choose_t = can_refract & (u2 > fresnel)

    rad = jnp.radians(180.0 - (1.0 - mp.roughness) * 180.0)
    sx, sy, sz = sample_angle3(u1, u2, rad)
    nf_unnorm = faceforward3(n, -wi, n)

    wo_t = local_to_world_normal3(sx, sy, sz, refr)
    flip_t = dot3(wo_t, nf_unnorm) > 0.0
    wo_t = where3(flip_t, local_to_world_normal3(-sx, -sy, sz, refr), wo_t)
    ft = mp.volume * ((1.0 - fresnel) * (eta_i * eta_i) / (eta_t * eta_t))
    refl_t = ft * (1.0 / _abs_dot_safe3(wo_t, n))

    reflected = reflect3(-wi, nf_unnorm)
    wo_r = local_to_world_normal3(sx, sy, sz, reflected)
    flip_r = dot3(wo_r, nf_unnorm) < 0.0
    wo_r = where3(flip_r, local_to_world_normal3(-sx, -sy, sz, reflected),
                  wo_r)
    refl_r = mp.specular * (fresnel / _abs_dot_safe3(wo_r, n))

    wo = where3(choose_t, wo_t, wo_r)
    refl = where3(choose_t, refl_t, refl_r)
    pdf = jnp.where(choose_t, 1.0 - fresnel, fresnel)
    nfl = flags | MATFLAG_SPECULAR_BOUNCE \
        | jnp.where(choose_t, MATFLAG_TRANSPARENT_BOUNCE, 0)
    return CoreBsdf(refl, wo, pdf, nfl)


def _b_lambert_transmission(mp, wi, n, u1, u2, flags):
    entering = dot3(wi, n) > 0.0
    lx, ly, lz = cosine_hemisphere3(u1, u2)
    sgn = jnp.where(entering, -1.0, 1.0)
    wo = local_to_world_normal3(lx * sgn, ly * sgn, lz * sgn, n)
    pdf = jnp.abs(dot3(wo, n)) / jnp.pi
    refl = where3(pdf == 0.0, 0.0, mp.volume * (1.0 / jnp.pi))
    return CoreBsdf(refl, wo, pdf,
                    jnp.full_like(flags, MATFLAG_TRANSPARENT_BOUNCE))


def _b_emission(mp, wi, n, u1, u2, flags):
    one = jnp.ones_like(u1)
    return CoreBsdf(V3(one, one, one), V3(one * 0.0, one * 0.0, one * 0.0),
                    one, jnp.full_like(flags, MATFLAG_EMISSIVE_BOUNCE))


def _b_transparent(mp, wi, n, u1, u2, flags):
    wo = -wi
    refl = mp.volume * (1.0 / _abs_dot_safe3(wo, n))
    return CoreBsdf(refl, wo, jnp.ones_like(u1),
                    jnp.full_like(flags,
                                  MATFLAG_TRANSPARENT_BOUNCE
                                  | MATFLAG_SPECULAR_BOUNCE))


_SURFACE3 = (
    (BSDF_LAMBERT, _b_lambert),
    (BSDF_SPECULAR_REFLECTION, _b_specular_reflection),
    (BSDF_SPECULAR_TRANSMISSION, _b_specular_transmission),
    (BSDF_GLOSSY, _b_glossy),
    (BSDF_GLASS, _b_glass),
    (BSDF_MILK_GLASS, _b_milk_glass),
    (BSDF_LAMBERT_TRANSMISSION, _b_lambert_transmission),
    (BSDF_EMISSION, _b_emission),
    (BSDF_TRANSPARENT, _b_transparent),
)


def sample_surface3(mp: CoreMat, wi: V3, n: V3, u1, u2, flags,
                    present: tuple = ()) -> CoreBsdf:
    """models/bsdf.sample_surface twin (same deterministic Lambert
    fall-through and zero-dot guard)."""
    bsdfs = [(b, f) for b, f in _SURFACE3 if not present or b in present]
    out = _b_lambert(mp, wi, n, u1, u2, flags)
    for bid, fn in bsdfs:
        if bid == BSDF_LAMBERT:
            continue
        res = fn(mp, wi, n, u1, u2, flags)
        is_b = mp.bsdf_id == bid
        out = CoreBsdf(
            refl=where3(is_b, res.refl, out.refl),
            wo=where3(is_b, res.wo, out.wo),
            pdf=jnp.where(is_b, res.pdf, out.pdf),
            flags=jnp.where(is_b, res.flags, out.flags),
        )
    grazing = dot3(wi, n) == 0.0
    return CoreBsdf(where3(grazing, 0.0, out.refl), out.wo, out.pdf,
                    out.flags)


def evaluate_light3(mp: CoreMat, n: V3, wi_light: V3, wo_view: V3) -> V3:
    """models/bsdf.evaluate_light twin."""
    same_side = (dot3(wi_light, n) * dot3(wo_view, n)) > 0.0
    lambert_like = (mp.bsdf_id == BSDF_LAMBERT) \
        | (mp.bsdf_id == BSDF_MARSCHNER_HAIR)
    translucent = mp.bsdf_id == BSDF_LAMBERT_TRANSMISSION
    m = (lambert_like & same_side) | (translucent & ~same_side)
    return where3(m, mp.diffuse * (1.0 / jnp.pi), 0.0)


_DELTA_EPS = 1e-3


def _glossy_cone3(mp: CoreMat):
    rad = jnp.radians(mp.roughness * 180.0)
    cos_max = jnp.cos(rad)
    inv_solid = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-6)
    return cos_max, inv_solid


def is_delta3(mp: CoreMat):
    bid = mp.bsdf_id
    smooth = (bid == BSDF_LAMBERT) | (bid == BSDF_LAMBERT_TRANSMISSION)
    glossy_wide = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    return ~(smooth | glossy_wide)


def eval_pdf3(mp: CoreMat, n: V3, wi_view: V3, wo: V3):
    """models/bsdf.eval_pdf twin -> (f V3, pdf)."""
    bid = mp.bsdf_id
    won = normalize3(wo)
    cos_o = dot3(won, n)
    cos_i = dot3(normalize3(wi_view), n)
    same_side = (cos_o * cos_i) > 0.0
    abs_cos = jnp.maximum(jnp.abs(cos_o), EPS)

    f = v3_full(cos_o.shape, 0.0)
    pdf = jnp.zeros_like(cos_o)

    m = (bid == BSDF_LAMBERT) & same_side
    f = where3(m, mp.diffuse * (1.0 / jnp.pi), f)
    pdf = jnp.where(m, abs_cos / jnp.pi, pdf)

    m = (bid == BSDF_LAMBERT_TRANSMISSION) & ~same_side
    f = where3(m, mp.volume * (1.0 / jnp.pi), f)
    pdf = jnp.where(m, abs_cos / jnp.pi, pdf)

    glos = (bid == BSDF_GLOSSY) & (mp.roughness > _DELTA_EPS)
    nf = faceforward3(n, -wi_view, n)
    reflected = normalize3(reflect3(normalize3(-wi_view), nf))
    cos_max, inv_solid = _glossy_cone3(mp)
    in_cone = dot3(won, reflected) >= cos_max
    m = glos & in_cone & same_side
    f = where3(m, mp.specular * (inv_solid / abs_cos), f)
    pdf = jnp.where(m, inv_solid, pdf)

    hair = (bid == BSDF_MARSCHNER_HAIR) | (bid == BSDF_DEON_HAIR)
    f = where3(hair & same_side, mp.diffuse * (1.0 / jnp.pi), f)
    return f, pdf


def sample_pdf3(mp: CoreMat, n: V3, wi_view: V3, wo: V3):
    _, pdf = eval_pdf3(mp, n, wi_view, wo)
    return jnp.where(is_delta3(mp), -1.0, jnp.maximum(pdf, 1e-8))


# ---------------------------------------------------------------------------
# Hair automaton (models/fur.py twins)
# ---------------------------------------------------------------------------

class CoreHair(NamedTuple):
    refl: V3
    wo: V3
    pdf: jnp.ndarray
    flags: jnp.ndarray
    theta_i: jnp.ndarray


def _to_cyl3(x: V3, fu: V3, fv: V3, fw: V3):
    """fur._to_cyl twin: components (along-axis V, U, W)."""
    return dot3(x, fv), dot3(x, fu), dot3(x, fw)


def _theta3(c0, c1, c2):
    r = jnp.sqrt(jnp.maximum(c0 * c0 + c2 * c2, 1e-20))
    return atan2_(r, c1)


def _phi3(c0, c1):
    degenerate = (jnp.abs(c0) < 1e-12) & (jnp.abs(c1) < 1e-12)
    return atan2_(c0, jnp.where(degenerate, 1.0, c1))


def _marschner3(mp: CoreMat, nin: V3, n: V3, fu: V3, fv: V3, fw: V3,
                flags, p_choice) -> CoreHair:
    """fur.marschner_sample twin."""
    alpha = mp.hair_alpha
    beta = mp.hair_beta
    ic0, ic1, ic2 = _to_cyl3(nin, fu, fv, fw)
    theta_i = _theta3(ic0, ic1, ic2)
    nf = faceforward3(n, -nin, n)
    gamma_i = angle_between3(nin, normalize3(n))
    h = jnp.sin(gamma_i)
    b1, b2 = _bravais(mp.ior, gamma_i)
    fresnel = dielectric_fresnel(gamma_i, b1, b2)
    pi = jnp.pi

    # R
    wo_r = rotate3(reflect3(-nin, nf), fv, -alpha)
    oc0, oc1, oc2 = _to_cyl3(wo_r, fu, fv, fw)
    th_r = _theta3(oc0, oc1, oc2)
    th_h = 0.5 * (th_r + theta_i)
    th_d = 0.5 * (th_r - theta_i)
    pdf_r = normal_gauss_pdf(th_h - alpha, 0.0, beta)
    dh_dphi = jnp.abs(_safe_div(
        -2.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))))
    n_r = 0.5 * fresnel * dh_dphi
    scat_r = pdf_r * n_r / jnp.maximum(jnp.cos(th_d) ** 2, _EPS)
    refl_r = V3(scat_r, scat_r, scat_r)

    # first-hit TT/TRT entry
    wo_enter = refract3(-nin, nf, 1.0 / mp.ior)
    flag_enter = jnp.where(p_choice == 2, MATFLAG_CYLINDER_TR_BOUNCE,
                           MATFLAG_CYLINDER_T_BOUNCE).astype(jnp.int32)

    # TT exit
    wo_tt = rotate3(refract3(-nin, nf, jnp.ones_like(h)), fv, alpha / 2.0)
    tc0, tc1, tc2 = _to_cyl3(wo_tt, fu, fv, fw)
    th_r_tt = _theta3(tc0, tc1, tc2)
    th_h_tt = 0.5 * (th_r_tt + theta_i)
    th_d_tt = 0.5 * (th_r_tt - theta_i)
    pdf_tt = normal_gauss_pdf(th_h_tt + alpha / 2.0, 0.0, beta / 2.0)
    c_tt = asin_(_clip1(1.0 / b1))
    denom = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))) * (
        -(24.0 * c_tt / pi ** 3) * gamma_i ** 2 + (6.0 * c_tt / pi - 2.0))
    dh_dphi_tt = _safe_div(1.0, jnp.abs(denom))
    cos_gamma_t = -2.0 * jnp.cos(asin_(_clip1(h / b1)))
    inv_ctr = 1.0 / jnp.maximum(jnp.cos(th_r_tt), _EPS)
    sigma = mp.diffuse * inv_ctr
    att = V3(jnp.exp(sigma.x * cos_gamma_t), jnp.exp(sigma.y * cos_gamma_t),
             jnp.exp(sigma.z * cos_gamma_t)) * ((1.0 - fresnel) ** 2)
    n_tt = att * (0.5 * dh_dphi_tt)
    refl_tt = n_tt * (pdf_tt / jnp.maximum(jnp.cos(th_d_tt) ** 2, _EPS))

    # TR internal reflection step
    wo_tr = reflect3(-nin, nf)
    flags_tr = jnp.full_like(
        flags,
        MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE
        | MATFLAG_SPECULAR_BOUNCE)

    # TRT exit
    wo_trt = rotate3(refract3(-nin, nf, jnp.ones_like(h)), fv,
                     3.0 * alpha / 2.0)
    rc0, rc1, rc2 = _to_cyl3(wo_trt, fu, fv, fw)
    th_r_trt = _theta3(rc0, rc1, rc2)
    th_h_trt = 0.5 * (th_r_trt + theta_i)
    th_d_trt = 0.5 * (th_r_trt - theta_i)
    pdf_trt = normal_gauss_pdf(th_h_trt + 3.0 * alpha / 2.0, 0.0, 2.0 * beta)
    denom2 = _safe_div(1.0, jnp.sqrt(jnp.maximum(1.0 - h * h, _EPS))) * (
        -(48.0 * c_tt / pi ** 3) * gamma_i ** 2 + (12.0 * c_tt / pi - 2.0))
    dh_dphi_trt = _safe_div(1.0, jnp.abs(denom2))
    gamma_t = asin_(_clip1(h / b1))
    cos_gt = jnp.cos(gamma_t)
    fresnel_exit = dielectric_fresnel(gamma_t, 1.0 / b1, 1.0 / b2)
    inv_ctr2 = 1.0 / jnp.maximum(jnp.cos(th_r_trt), _EPS)
    sigma2 = mp.diffuse * inv_ctr2
    e2 = V3(jnp.exp(sigma2.x * (-2.0 * cos_gt)),
            jnp.exp(sigma2.y * (-2.0 * cos_gt)),
            jnp.exp(sigma2.z * (-2.0 * cos_gt)))
    att2 = (e2 * e2) * ((1.0 - fresnel) ** 2 * fresnel_exit)
    n_trt = att2 * (0.5 * dh_dphi_trt)
    refl_trt = n_trt * (10.0 * pdf_trt
                        / jnp.maximum(jnp.cos(th_d_trt) ** 2, _EPS))

    # automaton select
    t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0
    tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0
    state_tt = t_set & ~tr_set
    state_tr = tr_set & ~t_set
    state_trt = tr_set & t_set
    first = p_choice == 0

    zero3 = v3_full(h.shape, 0.0)
    ones = jnp.ones_like(h)
    zeros_i = jnp.zeros_like(flags)
    spec_i = jnp.full_like(flags, MATFLAG_SPECULAR_BOUNCE)

    f_refl = where3(first, refl_r, zero3)
    f_wo = where3(first, wo_r, wo_enter)
    f_pdf = jnp.where(first, pdf_r, 1.0)
    f_flags = jnp.where(first, spec_i, flag_enter)
    f_th = jnp.where(first, theta_i, 0.0)

    refl = where3(state_tt, refl_tt,
           where3(state_tr, zero3, where3(state_trt, refl_trt, f_refl)))
    wo = where3(state_tt, wo_tt,
         where3(state_tr, wo_tr, where3(state_trt, wo_trt, f_wo)))
    pdf = jnp.where(state_tt, pdf_tt, jnp.where(state_tr, ones,
          jnp.where(state_trt, pdf_trt, f_pdf)))
    fl = jnp.where(state_tt, zeros_i, jnp.where(state_tr, flags_tr,
         jnp.where(state_trt, zeros_i, f_flags)))
    th = jnp.where(state_tt, theta_i, jnp.where(state_tr, 0.0,
         jnp.where(state_trt, theta_i, f_th)))
    return CoreHair(refl, wo, pdf, fl.astype(jnp.int32), th)


def _deon3(mp: CoreMat, nin: V3, n: V3, fu: V3, fv: V3, fw: V3,
           flags, p_choice) -> CoreHair:
    """fur.deon_sample twin."""
    ic0, ic1, ic2 = _to_cyl3(nin, fu, fv, fw)
    alpha = jnp.radians(mp.hair_alpha)
    beta = jnp.radians(mp.hair_beta)
    ior = mp.ior

    theta_i_in = _theta3(ic0, ic1, ic2)
    phi_i = _phi3(ic0, ic1)
    gamma_i = angle_between3(nin, normalize3(n))
    h = jnp.sin(gamma_i)
    nf = faceforward3(n, -nin, n)

    # R
    wo_r = rotate3(reflect3(-nin, nf), fv, -alpha)
    rc0, rc1, rc2 = _to_cyl3(wo_r, fu, fv, fw)
    theta_r_r = _theta3(rc0, rc1, rc2)
    m_r = _deon_M(beta * beta, theta_i_in, theta_r_r, radians_quirk=True)
    phi_r_r = _phi3(rc0, rc1)
    d_r = 0.25 * jnp.abs(jnp.cos(phi_r_r - phi_i / 2.0))
    fres_r = dielectric_fresnel(
        0.5 * acos_(_clip1(dot3(nin, normalize3(wo_r)))), 1.0, ior)
    s_r = m_r * 0.5 * fres_r * d_r
    refl_r = V3(s_r, s_r, s_r)
    pdf_r = m_r

    # first-hit entry
    wo_enter = refract3(-nin, nf, 1.0 / ior)
    flag_enter = jnp.where(p_choice == 2, MATFLAG_CYLINDER_TR_BOUNCE,
                           MATFLAG_CYLINDER_T_BOUNCE).astype(jnp.int32)

    # TT exit
    wo_tt = rotate3(refract3(-nin, nf, jnp.ones_like(h)), fv, alpha / 2.0)
    tc0, tc1, tc2 = _to_cyl3(wo_tt, fu, fv, fw)
    theta_r_tt = _theta3(tc0, tc1, tc2)
    theta_d_tt = 0.5 * (theta_r_tt - theta_i_in)
    m_tt = _deon_M((beta / 2.0) ** 2, theta_i_in, theta_r_tt,
                   radians_quirk=False)
    phi_tt = _phi3(tc0, tc1) - phi_i
    cos_td = jnp.cos(theta_d_tt)
    bravais = jnp.sqrt(jnp.maximum(ior * ior - jnp.sin(theta_d_tt) ** 2,
                                   _EPS)) / jnp.maximum(cos_td, _EPS)
    d_tt = _deon_detector(phi_tt, jnp.degrees(beta / 2.0))
    fres_tt = dielectric_fresnel(
        acos_(_clip1(cos_td * jnp.cos(gamma_i))), ior, 1.0)
    cos_2gt = jnp.cos(2.0 * asin_(_clip1(h / bravais)))
    inv_c = 1.0 / jnp.maximum(jnp.cos(theta_r_tt), _EPS)
    sig = mp.diffuse * inv_c
    e = -2.0 * (1.0 + cos_2gt)
    att_tt = V3(jnp.exp(sig.x * e), jnp.exp(sig.y * e), jnp.exp(sig.z * e)) \
        * ((1.0 - fres_tt) ** 2)
    refl_tt = att_tt * (m_tt * 0.5 * d_tt)
    pdf_tt = m_tt

    # TR step
    wo_tr = reflect3(-nin, nf)
    flags_tr = jnp.full_like(
        flags, MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE
        | MATFLAG_SPECULAR_BOUNCE)

    # TRT exit
    wo_trt = rotate3(refract3(-nin, nf, jnp.ones_like(h)), fv,
                     3.0 * alpha / 2.0)
    xc0, xc1, xc2 = _to_cyl3(wo_trt, fu, fv, fw)
    theta_r_trt = _theta3(xc0, xc1, xc2)
    theta_d_trt = 0.5 * (theta_r_trt - theta_i_in)
    m_trt = _deon_M((beta * 2.0) ** 2, theta_i_in, theta_r_trt,
                    radians_quirk=False)
    phi_trt = _phi3(xc0, xc1) - phi_i
    cos_td2 = jnp.cos(theta_d_trt)
    bravais2 = jnp.sqrt(jnp.maximum(ior * ior - jnp.sin(theta_d_trt) ** 2,
                                    _EPS)) / jnp.maximum(cos_td2, _EPS)
    d_trt = _deon_detector(phi_trt, jnp.degrees(beta * 2.0))
    fres_trt = dielectric_fresnel(
        acos_(_clip1(cos_td2 * jnp.cos(gamma_i))), ior, 1.0)
    cos_2gt2 = jnp.cos(2.0 * asin_(_clip1(h / bravais2)))
    inv_c2 = 1.0 / jnp.maximum(jnp.cos(theta_r_trt), _EPS)
    sig2 = mp.diffuse * inv_c2
    e2s = -2.0 * (1.0 + cos_2gt2)
    base = V3(jnp.exp(sig2.x * e2s), jnp.exp(sig2.y * e2s),
              jnp.exp(sig2.z * e2s))
    att_trt = (base * base) * ((1.0 - fres_trt) ** 2 * fres_trt)
    refl_trt = att_trt * (m_trt * 0.5 * d_trt)
    pdf_trt = m_trt

    # select
    t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0
    tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0
    state_tt = t_set & ~tr_set
    state_tr = tr_set & ~t_set
    state_trt = tr_set & t_set
    first = p_choice == 0

    zero3 = v3_full(h.shape, 0.0)
    ones = jnp.ones_like(h)
    zeros_i = jnp.zeros_like(flags)
    spec_i = jnp.full_like(flags, MATFLAG_SPECULAR_BOUNCE)

    f_refl = where3(first, refl_r, zero3)
    f_wo = where3(first, wo_r, wo_enter)
    f_pdf = jnp.where(first, pdf_r, 1.0)
    f_flags = jnp.where(first, spec_i, flag_enter)

    refl = where3(state_tt, refl_tt,
           where3(state_tr, zero3, where3(state_trt, refl_trt, f_refl)))
    wo = where3(state_tt, wo_tt,
         where3(state_tr, wo_tr, where3(state_trt, wo_trt, f_wo)))
    pdf = jnp.where(state_tt, pdf_tt, jnp.where(state_tr, ones,
          jnp.where(state_trt, pdf_trt, f_pdf)))
    fl = jnp.where(state_tt, zeros_i, jnp.where(state_tr, flags_tr,
         jnp.where(state_trt, zeros_i, f_flags)))
    return CoreHair(refl, wo, pdf, fl.astype(jnp.int32), theta_i_in)


def sample_hair3(mp: CoreMat, wi: V3, n: V3, fu: V3, fv: V3, fw: V3,
                 flags, p_choice) -> CoreHair:
    nin = normalize3(wi)
    m = _marschner3(mp, nin, n, fu, fv, fw, flags, p_choice)
    d = _deon3(mp, nin, n, fu, fv, fw, flags, p_choice)
    is_deon = mp.bsdf_id == BSDF_DEON_HAIR
    return CoreHair(
        refl=where3(is_deon, d.refl, m.refl),
        wo=where3(is_deon, d.wo, m.wo),
        pdf=jnp.where(is_deon, d.pdf, m.pdf),
        flags=jnp.where(is_deon, d.flags, m.flags).astype(jnp.int32),
        theta_i=jnp.where(is_deon, d.theta_i, m.theta_i),
    )


# ---------------------------------------------------------------------------
# The fused bounce shade (trace_bounce's post-traversal stage, one pass)
# ---------------------------------------------------------------------------

def shade_bounce_core(
    *,
    origin: V3, direction: V3, radiance: V3, color: V3,
    flags, theta_i, prev_pdf,
    hit_t, hit_valid,
    hit_pos: V3, hit_normal: V3,
    fib_u: V3, fib_v: V3, fib_w: V3,
    mp: CoreMat,
    env_color: V3,  # per-ray environment radiance for `direction`
    env_ambient: V3,  # scene-constant ambient (0-d components broadcast)
    lights: list,  # list[CoreLight], static length
    u_bsdf1, u_bsdf2, u_pick, u_light1, u_light2, u_hairp, u_rr,
    rr_gate,  # scalar-ish 0/1: bounce >= cfg.rr_start
    cfg: CoreCfg,
) -> CoreOut:
    """One wavefront bounce AFTER the scene traversal: light analytic hits,
    env/light termination, NEE setup (shadow ray emitted, occlusion applied
    by the CALLER), BSDF/hair sampling, throughput/flag/ray update.

    Semantics: models/pathtracer.trace_bounce line-for-line, with the NEE
    direct term factored out as (shadow ray, direct_rgb) so the scene
    occlusion test can run in the traversal kernels outside this pass.
    """
    shape = hit_t.shape
    active = (radiance.x != 0.0) | (radiance.y != 0.0) | (radiance.z != 0.0)
    has_dir = (direction.x != 0.0) | (direction.y != 0.0) \
        | (direction.z != 0.0)
    do_trace = active & has_dir

    # --- analytic light intersections (traceRay:185-208)
    if cfg.n_lights:
        t_light = jnp.full(shape, INF, jnp.float32)
        light_ix = jnp.full(shape, 0, jnp.int32)
        for l, li in enumerate(lights):
            tl, _ = light_hit3(origin, direction, li)
            better = tl < t_light
            t_light = jnp.where(better, tl, t_light)
            light_ix = jnp.where(better, l, light_ix)
        light_wins = t_light < hit_t
    else:
        light_wins = jnp.zeros(shape, bool)
        light_ix = jnp.zeros(shape, jnp.int32)
        t_light = jnp.full(shape, INF, jnp.float32)

    miss = do_trace & ~hit_valid & ~light_wins
    hit_light = do_trace & light_wins
    hit_geom = do_trace & hit_valid & ~light_wins

    color = color + where3(miss, env_color * radiance, 0.0)

    if cfg.n_lights:
        lrad = v3_full(shape, 0.0)
        for l, li in enumerate(lights):
            sel = light_ix == l
            lrad = where3(sel, light_emitted3(li, direction), lrad)
        if cfg.mis:
            p_b = prev_pdf
            delta = p_b <= 0.0
            p_l = jnp.zeros(shape, jnp.float32)
            area_like = jnp.zeros(shape, bool)
            for l, li in enumerate(lights):
                sel = light_ix == l
                p_l = jnp.where(sel, light_solid_angle_pdf3(
                    li, cfg.n_lights, direction, t_light), p_l)
                area_like |= sel & ((li.kind == LIGHT_QUAD)
                                    | (li.kind == LIGHT_POINT))
            w = jnp.where(delta, 1.0,
                jnp.where(area_like, power_heuristic(p_b, p_l), 0.0))
            lrad = lrad * w
        color = color + where3(hit_light, lrad * radiance, 0.0)

    radiance = where3(miss | hit_light, 0.0, radiance)

    # --- sanitize hit fields (NaN guard parity with trace_bounce)
    up = V3(jnp.zeros(shape, jnp.float32), jnp.ones(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32))
    xax = V3(jnp.ones(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
             jnp.zeros(shape, jnp.float32))
    zax = V3(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
             jnp.ones(shape, jnp.float32))
    n = where3(hit_valid, hit_normal, up)
    pos = where3(hit_valid, hit_pos, 0.0)
    fu = where3(hit_valid, fib_u, xax)
    fv = where3(hit_valid, fib_v, up)
    fw = where3(hit_valid, fib_w, zax)
    counter = -normalize3(direction)

    # --- NEE (calcDirectLight / calc_direct_light_mis), occlusion deferred
    if cfg.n_lights:
        pick = jnp.minimum((u_pick * cfg.n_lights).astype(jnp.int32),
                           cfg.n_lights - 1)
        # select the picked light's sample across the static loop
        target = v3_full(shape, 0.0)
        att = jnp.zeros(shape, jnp.float32)
        le = v3_full(shape, 0.0)
        lcolor = v3_full(shape, 0.0)
        p_l = jnp.zeros(shape, jnp.float32)
        area_like = jnp.zeros(shape, bool)
        for l, li in enumerate(lights):
            sel = pick == l
            tgt_l, att_l = light_sample_dir3(li, pos, u_light1, u_light2)
            target = where3(sel, tgt_l, target)
            att = jnp.where(sel, att_l, att)
            lcolor = where3(sel, li.color, lcolor)
            area_like |= sel & ((li.kind == LIGHT_QUAD)
                                | (li.kind == LIGHT_POINT))

        direction_l = target - pos
        dist = length3(direction_l)
        wi = normalize3(direction_l)
        if cfg.mis:
            offset_n = faceforward3(n, -wi, n)
            sh_o = pos + offset_n * 1e-4
            for l, li in enumerate(lights):
                sel = pick == l
                le = where3(sel, light_emitted3(li, wi), le)
                p_l = jnp.where(sel, light_solid_angle_pdf3(
                    li, cfg.n_lights, wi, dist), p_l)
            f, bpdf = eval_pdf3(mp, n, -normalize3(direction), wi)
            cos_x = jnp.abs(dot3(wi, n))
            w = power_heuristic(p_l, bpdf)
            contrib_area = le * f * (cos_x * w / jnp.maximum(p_l, 1e-12))
            contrib_ref = lcolor * f * (att * cos_x * cfg.n_lights)
            contrib = where3(area_like, contrib_area, contrib_ref)
            t_max = dist * (1.0 - 1e-3)
        else:
            lightpos = pos + direction_l
            offset_n = faceforward3(n, pos - lightpos, n)
            sh_o = pos + offset_n * 1e-4
            f = evaluate_light3(mp, n, wi, -normalize3(direction))
            contrib = lcolor * f * (att * jnp.abs(dot3(wi, n)))
            t_max = length3(lightpos - sh_o)
        t_max = jnp.where(hit_geom, t_max, 0.0)
        # light geometry also occludes (SimpleShader.h:135-144) — elementwise
        light_blocked = jnp.zeros(shape, bool)
        for l, li in enumerate(lights):
            tl, okl = light_hit3(sh_o, wi, li)
            if cfg.mis:
                light_blocked |= okl & (pick != l) & (tl < t_max)
            else:
                light_blocked |= okl & (tl < t_max)
        has_color = jnp.zeros(shape, bool)
        for l, li in enumerate(lights):
            sel = pick == l
            has_color |= sel & ((li.color.x > 0.0) | (li.color.y > 0.0)
                                | (li.color.z > 0.0))
        direct = where3(has_color & ~light_blocked, contrib, 0.0)
        shadow_o, shadow_d, shadow_tmax = sh_o, wi, t_max
    else:
        direct = v3_full(shape, 0.0)
        shadow_o = v3_full(shape, 0.0)
        shadow_d = up
        shadow_tmax = jnp.zeros(shape, jnp.float32)

    # ambient = env_ambient * evaluateLight(n, n) / pi — caller folds the
    # (scene-constant) env ambient into `ambient_rgb` below via mp
    ambient = evaluate_light3(mp, n, n, n)  # diffuse/pi for lambert-like

    # --- BSDF sample
    bs = sample_surface3(mp, counter, n, u_bsdf1, u_bsdf2, flags,
                         present=cfg.bsdfs_present)
    if cfg.has_hair:
        if cfg.hair_p_random:
            p_choice = jnp.minimum((u_hairp * 3).astype(jnp.int32), 2)
        else:
            p_choice = jnp.zeros_like(flags)
        hs = sample_hair3(mp, counter, n, fu, fv, fw, flags, p_choice)
        is_hair = mp.shader_id == SHADER_MARSCHNER_HAIR
        refl = where3(is_hair, hs.refl, bs.refl)
        wo = where3(is_hair, hs.wo, bs.wo)
        pdf = jnp.where(is_hair, hs.pdf, bs.pdf)
        new_flags = jnp.where(is_hair, hs.flags, bs.flags)
        hs_theta_i = hs.theta_i
    else:
        is_hair = jnp.zeros(shape, bool)
        refl, wo, pdf, new_flags = bs.refl, bs.wo, bs.pdf, bs.flags
        hs_theta_i = theta_i

    refl_zero = (refl.x == 0.0) & (refl.y == 0.0) & (refl.z == 0.0)
    if cfg.rr:
        weak = jnp.zeros(shape, bool)
    else:
        weak = jnp.maximum(radiance.x,
                           jnp.maximum(radiance.y, radiance.z)) < 0.01
    kill = refl_zero | (pdf <= 1e-4) | weak

    emissive = (new_flags & MATFLAG_EMISSIVE_BOUNCE) != 0
    mid_walk = (new_flags & (MATFLAG_CYLINDER_T_BOUNCE
                             | MATFLAG_CYLINDER_TR_BOUNCE)) != 0
    specular = (new_flags & MATFLAG_SPECULAR_BOUNCE) != 0
    off_spec = wo * 1e-4
    off_diff = faceforward3(-1e-4 * n, n, wo)
    offset = where3(specular, off_spec, off_diff)
    new_origin = pos + offset
    new_direction = wo

    # direct-term coefficient: color += direct * radiance on geom lanes,
    # suppressed mid-walk for hair (hair_color = where(mid_walk, 0, accum))
    direct_gate = hit_geom & ~(is_hair & mid_walk)
    direct_rgb = where3(direct_gate, direct * radiance, 0.0)
    shadow_tmax = jnp.where(direct_gate, shadow_tmax, 0.0)

    # ambient part of accum goes straight into color (no occlusion):
    # env_ambient * evaluateLight(n, n) / pi (SimpleShader.h:47)
    amb_rgb = (env_ambient * ambient * (1.0 / jnp.pi)) * radiance

    # --- SimpleShader / MarschnerHairShader color & throughput updates
    simple_color = amb_rgb + where3(emissive & ~kill, mp.emission * radiance,
                                    0.0)
    inv_pdf = 1.0 / jnp.maximum(pdf, 1e-20)
    simple_radiance = where3(
        kill | emissive, 0.0,
        radiance * refl * (jnp.abs(dot3(wo, n)) * inv_pdf))

    hair_color = where3(mid_walk, 0.0, amb_rgb)
    hair_radiance = where3(
        mid_walk, radiance,
        where3(kill, 0.0,
               radiance * refl * (3.0 * jnp.abs(jnp.cos(hs_theta_i)))))

    color = color + where3(hit_geom,
                           where3(is_hair, hair_color, simple_color), 0.0)
    radiance = where3(hit_geom,
                      where3(is_hair, hair_radiance, simple_radiance),
                      radiance)
    radiance = V3(jnp.minimum(radiance.x, cfg.clamp_throughput),
                  jnp.minimum(radiance.y, cfg.clamp_throughput),
                  jnp.minimum(radiance.z, cfg.clamp_throughput))

    if cfg.rr:
        q = jnp.clip(jnp.maximum(radiance.x,
                                 jnp.maximum(radiance.y, radiance.z)),
                     0.05, 1.0)
        do_rr = (rr_gate > 0.0) & hit_geom & ~mid_walk
        dead = do_rr & (u_rr >= q)
        boost = jnp.where(do_rr & ~dead, 1.0 / q, 1.0)
        radiance = where3(dead, 0.0, radiance * boost)

    continuing = hit_geom & ~kill & ~emissive
    hair_moves = hit_geom & is_hair
    move = continuing | hair_moves
    origin = where3(move, new_origin, origin)
    direction = where3(move, new_direction, direction)
    flags = jnp.where(hit_geom & is_hair, new_flags,
            jnp.where(continuing & ~is_hair, new_flags, flags))
    theta_i = jnp.where(hit_geom & is_hair, hs_theta_i, theta_i)

    if cfg.mis:
        spdf = sample_pdf3(mp, n, counter, wo)
        spdf = jnp.where(is_hair, -1.0, spdf)
        prev_pdf = jnp.where(hit_geom, spdf, prev_pdf)

    return CoreOut(origin=origin, direction=direction, radiance=radiance,
                   color=color, flags=flags, theta_i=theta_i,
                   prev_pdf=prev_pdf, shadow_o=shadow_o, shadow_d=shadow_d,
                   shadow_tmax=shadow_tmax, direct_rgb=direct_rgb)
