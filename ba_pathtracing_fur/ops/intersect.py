"""Ray–primitive intersection kernels (pure jnp, grid-broadcast).

These are the jnp oracles for the accelerated paths (the LBVH and the
level-2 kernel; SURVEY §4 principle: every accelerated path has a
brute-force reference twin).

- Triangles: Möller–Trumbore. The reference sorts triangle vertices by
  longest axis and uses a custom test (Triangle.cpp:1-120); geometrically
  both return identical hits, so this build uses the standard fused form.
- Cones: exact parity with KIRK::Cylinder::closestIntersection's quadratic,
  slab clamp and root selection (Cylinder.cpp:73-156), with the corrected
  `a` term used by isIntersection (Cylinder.cpp:173) which is valid for
  unnormalized directions.
- Lights: analytic emitter intersections (Light.cpp:169-189, 227-232,
  367-428, 497-501); lights live OUTSIDE the accel structure, exactly like
  the reference (CPU_PathTracer.cpp:185-208).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import vecmath as vm
from ..scene.types import (
    ConePack, LightPack, TrianglePack,
    LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, LIGHT_SUN,
)

# numpy scalar, NOT jnp: a module-level jnp constant commits to a device at
# IMPORT time, initializing the backend before callers (scaling CLI, the
# multichip dryrun) can force their platform/device-count config. Promotion
# behavior in jnp expressions is identical (strong f32 scalar).
INF = np.float32(3.4e38)
TRI_EPS = 1.1920929e-7  # FLT_EPSILON, as used by Light::intersectTriangle


# ---------------------------------------------------------------------------
# Triangle
# ---------------------------------------------------------------------------

def triangle_hit_grid(o, d, tris: TrianglePack, t_min, t_max):
    """All-pairs ray×triangle hits.

    o, d: [R,3]. Returns (t [R,T], u [R,T], v [R,T], valid [R,T]).

    Component-wise [R,T] math throughout: an [R,T,3] layout would make the
    3-wide axis the innermost one; with [R,T] arrays the T axis is
    contiguous and every op is dense.
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [R,1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    v0x, v0y, v0z = tris.v0[None, :, 0], tris.v0[None, :, 1], tris.v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]

    # p = d × e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near_zero = jnp.abs(det) < TRI_EPS
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # q = tvec × e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (~near_zero)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < t_max)
    )
    return jnp.where(valid, t, INF), u, v, valid


def triangle_interpolate(tris: TrianglePack, tri_id, point, o, d):
    """Recompute barycentrics at the winning triangle and interpolate
    normal/uv (Triangle barycentric interp parity)."""
    return triangle_interpolate_rows(
        TrianglePack(v0=tris.v0[tri_id], v1=tris.v1[tri_id],
                     v2=tris.v2[tri_id], n0=tris.n0[tri_id],
                     n1=tris.n1[tri_id], n2=tris.n2[tri_id],
                     uv0=tris.uv0[tri_id], uv1=tris.uv1[tri_id],
                     uv2=tris.uv2[tri_id], mat_id=tris.mat_id[tri_id],
                     fiber_u=tris.fiber_u[tri_id],
                     fiber_v=tris.fiber_v[tri_id],
                     fiber_w=tris.fiber_w[tri_id]), point, o, d)


def triangle_interpolate_rows(rp: TrianglePack, point, o, d):
    """triangle_interpolate on an already-gathered per-ray row pack
    (leaves [R, ...]) — the gather-consolidated assembly path."""
    v0 = rp.v0
    e1 = rp.v1 - v0
    e2 = rp.v2 - v0
    p = jnp.cross(d, e2)
    det = vm.dot(e1, p, keepdims=True)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < TRI_EPS, 1.0, det)
    tvec = o - v0
    u = (vm.dot(tvec, p, keepdims=True) * inv_det)
    q = jnp.cross(tvec, e1)
    v = (vm.dot(d, q, keepdims=True) * inv_det)
    w = 1.0 - u - v
    normal = vm.normalize(w * rp.n0 + u * rp.n1 + v * rp.n2)
    uv = w * rp.uv0 + u * rp.uv1 + v * rp.uv2
    return normal, uv, jnp.concatenate([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Cone (fur fiber segment)
# ---------------------------------------------------------------------------

def cone_hit_grid(o, d, cones: ConePack, t_min, t_max, ray_eps=1e-4):
    """All-pairs ray×cone hits with KIRK root-selection semantics.

    Returns (t [R,F], enter [R,F] bool, valid [R,F]).
    """
    # to local frame: P = o - base projected on (u,v,w); D likewise.
    # Component-wise [R,F] math — see triangle_hit_grid on why not
    # [R,F,3].
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [R,1]
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    bx, by, bz = cones.base[None, :, 0], cones.base[None, :, 1], cones.base[None, :, 2]
    uxx, uxy, uxz = cones.u[None, :, 0], cones.u[None, :, 1], cones.u[None, :, 2]
    vxx, vxy, vxz = cones.v[None, :, 0], cones.v[None, :, 1], cones.v[None, :, 2]
    wxx, wxy, wxz = cones.w[None, :, 0], cones.w[None, :, 1], cones.w[None, :, 2]
    rx, ry, rz = ox - bx, oy - by, oz - bz
    px = rx * uxx + ry * uxy + rz * uxz
    py = rx * vxx + ry * vxy + rz * vxz
    pz = rx * wxx + ry * wxy + rz * wxz
    dx = rdx * uxx + rdy * uxy + rdz * uxz
    dy = rdx * vxx + rdy * vxy + rdz * vxz
    dz = rdx * wxx + rdy * wxy + rdz * wxz

    slope = cones.slope[None]
    r_base = cones.r_base[None]

    a = dx * dx + dz * dz - slope * slope * dy * dy  # Cylinder.cpp:173
    b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    c_lin = r_base - slope * py
    c = px * px + pz * pz - c_lin * c_lin

    disc = b * b - a * c
    has_roots = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    a_safe = jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    t1 = (-b - sq) / a_safe
    t2 = (-b + sq) / a_safe
    # a<0 flips ordering; keep t1<=t2
    t1, t2 = jnp.minimum(t1, t2), jnp.maximum(t1, t2)

    # slab clamp: d_axis = dot(v, o + t*d) within [min_d, max_d].
    # dot(v, o) and dot(v, d) are the already-computed frame projections.
    o_ax = ox * vxx + oy * vxy + oz * vxz  # [R,F]: dot(v_axis, o)
    d_ax = rdx * vxx + rdy * vxy + rdz * vxz

    def axis_ok(t):
        dax = o_ax + t * d_ax
        return (dax >= cones.min_d[None]) & (dax <= cones.max_d[None])

    t1_ok = (t1 >= ray_eps) & (t1 > t_min) & (t1 < t_max) & axis_ok(t1)
    t2_ok = (t2 >= ray_eps) & (t2 > t_min) & (t2 < t_max) & axis_ok(t2)

    take_t1 = has_roots & t1_ok
    take_t2 = has_roots & (~t1_ok) & t2_ok
    t = jnp.where(take_t1, t1, jnp.where(take_t2, t2, INF))
    enter = take_t1  # entering hit == nearer root (Cylinder.cpp:126,140)
    valid = take_t1 | take_t2
    return t, enter, valid


def cone_normal(cones: ConePack, cone_id, point):
    """Cylinder::calcNormal (Cylinder.cpp:230-237): radial dir + slope tilt."""
    return cone_normal_rows(cones.v[cone_id], cones.base[cone_id],
                            cones.base_d[cone_id], cones.slope[cone_id],
                            point)


def cone_normal_rows(v_ax, base, base_d, slope, point):
    """cone_normal on already-gathered per-ray components [R, ...]."""
    t_axis = vm.dot(point, v_ax, keepdims=True) - base_d[..., None]
    q1 = point - t_axis * v_ax
    n = vm.normalize(q1 - base)
    return vm.normalize(n + slope[..., None] * v_ax)


def cone_texcoord(cones: ConePack, cone_id, point):
    """Cylinder::calcTcoord (Cylinder.cpp:239-260): (phi/2pi, v/height)."""
    return cone_texcoord_rows(cones.base[cone_id], cones.u[cone_id],
                              cones.v[cone_id], cones.w[cone_id],
                              cones.r_base[cone_id], cones.slope[cone_id],
                              cones.height[cone_id], point)


def cone_texcoord_rows(base, u_ax, v_ax, w_ax, r_base, slope, height, point):
    """cone_texcoord on already-gathered per-ray components [R, ...]."""
    rel = point - base
    u = vm.dot(rel, u_ax)
    v = vm.dot(rel, v_ax)
    w = vm.dot(rel, w_ax)
    r = r_base - slope * v
    tmp = jnp.clip(w / jnp.where(jnp.abs(r) < 1e-12, 1e-12, r), -1.0 + 1e-7, 1.0 - 1e-7)
    phi = jnp.where(u < 0.0, 2.0 * jnp.pi - jnp.arccos(tmp), jnp.arccos(tmp))
    return jnp.stack([phi / (2.0 * jnp.pi), v / height], axis=-1)


def cone_aabbs(cones: ConePack):
    """World AABBs of the local bound box (Cylinder::computeBounds,
    Cylinder.cpp:306-336), in closed form: the min/max over the 8 corners
    base + sx*r*u + sy*h*v + sz*r*w (sx,sz in {-1,1}, sy in {0,1})
    separates per world axis into base + min/max(0, h*v) -/+ r*(|u|+|w|).
    Identical bounds to enumerating the corners (modulo f32 association, and
    conservative either way), ~8x fewer passes — the corner loop was the
    single most expensive stage of the 9M-cone hair-ball build (18.7 s
    measured). Returns ([F,3],[F,3]); works on host and device alike."""
    import numpy as _np
    xp = _np if isinstance(cones.base, _np.ndarray) else jnp
    radius = (xp.maximum(cones.r_base, cones.r_apex) + 1e-6)[:, None]
    hv = cones.height[:, None] * cones.v
    r_uw = radius * (xp.abs(cones.u) + xp.abs(cones.w))
    lo = cones.base + xp.minimum(hv, 0.0) - r_uw
    hi = cones.base + xp.maximum(hv, 0.0) + r_uw
    return lo, hi


def triangle_aabbs(tris: TrianglePack):
    import numpy as _np
    xp = _np if isinstance(tris.v0, _np.ndarray) else jnp
    pts = xp.stack([tris.v0, tris.v1, tris.v2], axis=1)
    return pts.min(axis=1), pts.max(axis=1)


def cone_centroids(cones: ConePack):
    """AABB centroids of cone_aabbs in closed form: 0.5*(lo+hi) =
    base + 0.5*height*v exactly — the radius terms cancel, so the split
    stage of the at-scale build (host side) pays ONE fused pass over the
    pack instead of the full 11-pass AABB evaluation (2.8-3.6 s of the
    9M-cone split was this AABB midpoint; this is ~0.2 s). Works on
    numpy and jnp packs alike (pure arithmetic)."""
    return cones.base + 0.5 * cones.height[:, None] * cones.v


def triangle_centroids(tris: TrianglePack):
    lo, hi = triangle_aabbs(tris)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# AABB slab test (for BVH)
# ---------------------------------------------------------------------------

def ray_aabb(o, inv_d, bmin, bmax, t_max):
    """Slab test. o, inv_d: [...,3]; bmin/bmax broadcastable. Returns
    (hit mask, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= t_max)
    return hit, tnear


# ---------------------------------------------------------------------------
# Lights (analytic emitters outside the accel structure)
# ---------------------------------------------------------------------------

def _tri_t(o, d, v1, v2, v3):
    """Möller–Trumbore t for a single triangle per (ray,light) pair; matches
    Light::intersectTriangle (Light.cpp:13-64). Returns (t, valid)."""
    e1 = v2 - v1
    e2 = v3 - v1
    p = jnp.cross(d, e2)
    det = vm.dot(e1, p)
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - v1
    u = vm.dot(tvec, p) * inv_det
    q = jnp.cross(tvec, e1)
    v = vm.dot(d, q) * inv_det
    t = vm.dot(e2, q) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > TRI_EPS)
    return t, ok


def light_hit_grid(o, d, lights: LightPack):
    """All-pairs ray×light analytic intersections.

    o, d: [R,3] -> (t [R,L], valid [R,L]). Per-kind semantics match
    PointLight/QuadLight/SpotLight/SunLight::isIntersection exactly,
    including the point light's facing precondition (Light.cpp:174) and its
    chosen root (-0.5*(b+sqrt(d))/a, Light.cpp:186).
    """
    ro = o[:, None]  # [R,1,3]
    rd = d[:, None]
    pos = lights.position[None]  # [1,L,3]
    kind = lights.kind[None]

    # --- point: sphere of light radius
    radius_sq = (lights.radius ** 2)[None]
    oc = ro - pos
    facing_away = vm.dot(rd, oc) > 0.0
    a = vm.dot(rd, rd)
    b = 2.0 * vm.dot(rd, oc)
    c = vm.dot(pos, pos) + vm.dot(ro, ro) - 2.0 * vm.dot(ro, pos) - radius_sq
    disc = b * b - 4.0 * a * c
    point_ok = (radius_sq > 0.0) & (~facing_away) & (disc >= 0.0)
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t_point = -0.5 * (b + sq) / jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)

    # --- quad: two triangles (v0,v1,v3) and (v2,v3,v1) (Light.cpp:231)
    v = lights.verts[None]  # [1,L,4,3]
    tq1, ok1 = _tri_t(ro, rd, v[..., 0, :], v[..., 1, :], v[..., 3, :])
    tq2, ok2 = _tri_t(ro, rd, v[..., 2, :], v[..., 3, :], v[..., 1, :])
    # second test overwrites t on success, mirroring the reference's
    # short-circuit `||` evaluation order
    t_quad = jnp.where(ok2, tq2, tq1)
    quad_ok = ok1 | ok2

    # --- spot: disk of radius about position perpendicular to direction
    nrm = lights.direction[None]
    s_ax, t_ax = vm.orthonormal_basis(nrm)
    e1 = s_ax
    e2 = t_ax
    p = jnp.cross(rd, e2)
    det = vm.dot(e1, p)
    ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = ro - pos
    uu = vm.dot(tvec, p) * inv_det
    q = jnp.cross(tvec, e1)
    vv = vm.dot(rd, q) * inv_det
    t_spot = vm.dot(e2, q) * inv_det
    spot_ok = ok & (uu * uu + vv * vv <= lights.radius[None] ** 2) & (t_spot > TRI_EPS) \
        & (lights.radius[None] > 0.0)

    t = jnp.where(kind == LIGHT_POINT, t_point,
        jnp.where(kind == LIGHT_QUAD, t_quad,
        jnp.where(kind == LIGHT_SPOT, t_spot, INF)))
    valid = jnp.where(kind == LIGHT_POINT, point_ok,
        jnp.where(kind == LIGHT_QUAD, quad_ok,
        jnp.where(kind == LIGHT_SPOT, spot_ok, False)))
    # SunLight: never intersectable (Light.cpp:497-501)
    return jnp.where(valid, t, INF), valid
