"""Independent KIRK-CPU parity oracle: a double-precision numpy
transliteration of the reference's CPU path-tracing math, written FROM THE
C++ ONLY and importing nothing from this package's model/ops code.

Purpose (VERDICT r4 missing #1): every other oracle in the test suite is
this codebase checked against itself (brute force vs BVH, Pallas vs XLA).
A shared transliteration bug in the shading math would pass all of them.
This module re-derives the same renders from the reference sources
directly, so `tests/test_reference_parity.py` can assert image-level
allclose between two INDEPENDENT implementations.

Transliterated call stack (all citations /root/reference/src/libraries/):
  Camera::applyParameters / getRayFromPixel   KIRK/Common/Camera.cpp:6-66
  Ray ctor (normalizes direction!)            KIRK/Common/Ray.cpp:11-21
  PathTracer::traceRays / traceRay            KIRK/CPU/CPU_Raytracer/
                                              CPU_PathTracer.cpp:129-211
  PathTracer::drawTexture running mean        CPU_PathTracer.cpp:61-90
  Triangle::closestIntersection               KIRK/Common/Triangle.cpp:152-185
  Triangle::calcNormal (barycentric interp)   Triangle.cpp:244-248
  QuadLight::isIntersection / calcLightdir /
  sampleLightSource / distanceAttenuation     KIRK/Common/Light.cpp:228-300,
                                              Light.h:70-73
  Light::intersectTriangle (Moller-Trumbore)  Light.cpp:13-64
  SimpleShader::shade / calcDirectLight       KIRK/Common/Shading/
                                              SimpleShader.h:31-152
  LightShader / EnvironmentShader             LightShader.h:20-26,
                                              EnvironmentShader.h:21-28
  LambertianReflectionBSDF::localSample /
  evaluateLight + BSDF::sample guard          KIRK/Common/Shading/
                                              Bsdf.cpp:179-209
  BSDFHelper concentricSampleDisk /
  cosineSampleHemisphere                      Bsdf.cpp:96-132
  Math::localToWorldNormal                    KIRK/Utils/Math.cpp:16-24

RNG is INJECTED: the caller supplies a `uniforms(bounce, tag, n)` callable
returning [R, n] float arrays (the same threefry draws the JAX renderer
consumes), so both implementations integrate the identical estimator and
the images must agree to float32-accumulation tolerance.

Scope: diffuse (Lambertian) surfaces, quad lights, constant-color
environment — the BASELINE config-1 Cornell estimator. The math here is
deliberately vectorized-over-rays numpy; vectorization does not change the
per-ray arithmetic being checked.
"""

from __future__ import annotations

import numpy as np

F = np.float64
FLT_EPSILON = float(np.finfo(np.float32).eps)  # Light.cpp:15
C_TRIANGLE_EPSILON = 1e-7  # Triangle.h:46
FLT_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# glm helpers
# ---------------------------------------------------------------------------

def _normalize(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.where(n == 0.0, 1.0, n)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _faceforward(n, i, nref):
    """glm::faceforward(N, I, Nref) = dot(Nref, I) < 0 ? N : -N."""
    return np.where(_dot(nref, i)[..., None] < 0.0, n, -n)


# ---------------------------------------------------------------------------
# Camera (Camera.cpp:6-66). The Ray ctor normalizes (Ray.cpp:14), so
# primary directions ARE unit here.
# ---------------------------------------------------------------------------

def camera_basis(position, look_at, up, resolution,
                 sensor_size=(0.036, 0.024), focal_length=0.0415):
    position = np.asarray(position, F)
    look_at = np.asarray(look_at, F)
    up = np.asarray(up, F)
    axis_z = _normalize(-look_at)
    axis_x = _normalize(np.cross(up, axis_z))
    axis_y = _normalize(np.cross(axis_z, axis_x))
    sensor = np.asarray(sensor_size, F)
    sensor_diameter = np.sqrt(sensor[0] ** 2 + sensor[1] ** 2)
    fov = 2.0 * np.arctan(sensor_diameter / (2.0 * focal_length))
    aspect = resolution[0] / resolution[1]
    sy = np.tan(0.5 * fov)
    sx = sy * aspect
    pixel_size = 2.0 * sx / resolution[0]
    bottom_left = position - axis_z - sy * axis_y - sx * axis_x
    return dict(position=position, axis_x=axis_x, axis_y=axis_y,
                bottom_left=bottom_left, pixel_size=pixel_size,
                resolution=tuple(resolution))


def primary_rays(cam, px, py, jitter):
    """getRayFromPixel (Camera.cpp:59-66) + Ray-ctor normalization."""
    x = (px + jitter[:, 0])[:, None]
    y = (py + jitter[:, 1])[:, None]
    direction = (cam["bottom_left"]
                 + x * cam["pixel_size"] * cam["axis_x"]
                 + y * cam["pixel_size"] * cam["axis_y"]
                 - cam["position"])
    o = np.broadcast_to(cam["position"], direction.shape).astype(F)
    return o.copy(), _normalize(direction)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def closest_triangle_hit(o, d, v0, v1, v2):
    """Brute-force nearest hit over all triangles with the EXACT
    Triangle::closestIntersection arithmetic (Triangle.cpp:152-185):
    d_v = cross(dir, ac); det = dot(d_v, ab); u = dot(d_v, w)*invDet;
    v = dot(cross(w, ab), dir)*invDet; t = dot(cross(w, ab), ac)*invDet.
    Returns (t [R], tri_index [R], bary [R,3]) with t = FLT_MAX on miss.

    Note: the reference ctor re-sorts each triangle's vertices by longest
    axis (Triangle.cpp:1-120); sorting permutes barycentrics but not the
    hit/t, and interpolation over equal per-vertex normals (flat shading,
    the scope here) is order-invariant, so the unsorted form is exact."""
    ab = (v1 - v0)[None]  # [1,T,3]
    ac = (v2 - v0)[None]
    d_e = d[:, None]  # [R,1,3]
    o_e = o[:, None]
    d_v = np.cross(d_e, ac)
    det = _dot(d_v, ab)  # [R,T]
    ok = np.abs(det) >= C_TRIANGLE_EPSILON
    inv_det = 1.0 / np.where(ok, det, 1.0)
    w = o_e - v0[None]
    u = _dot(d_v, w) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    w_u = np.cross(w, ab)
    v = _dot(w_u, d_e) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = _dot(w_u, ac) * inv_det
    # closestIntersectionWithCandidates runs tMin=0 (Container.h:21);
    # shading reuses cRayEpsilon-offset origins instead
    ok &= t > 0.0
    t = np.where(ok, t, FLT_MAX)
    idx = np.argmin(t, axis=-1)
    r = np.arange(o.shape[0])
    t_best = t[r, idx]
    u_b = u[r, idx]
    v_b = v[r, idx]
    bary = np.stack([1.0 - u_b - v_b, u_b, v_b], axis=-1)
    return t_best, idx.astype(np.int64), bary


def _intersect_triangle_any(o, d, v1, v2, v3):
    """Light::intersectTriangle (Light.cpp:13-64): FLT_EPSILON det guard,
    t > FLT_EPSILON. v1/v2/v3 are [3] single-triangle corners; o,d [R,3].
    Returns (hit [R], t [R])."""
    e1 = v2 - v1
    e2 = v3 - v1
    p = np.cross(d, e2[None])
    det = _dot(p, e1[None])
    ok = ~((det > -FLT_EPSILON) & (det < FLT_EPSILON))
    inv_det = 1.0 / np.where(ok, det, 1.0)
    tvec = o - v1[None]
    u = _dot(tvec, p) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    q = np.cross(tvec, e1[None])
    v = _dot(d, q) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = _dot(e2[None], q) * inv_det
    ok &= t > FLT_EPSILON
    return ok, np.where(ok, t, FLT_MAX)


def quad_light_hit(o, d, verts):
    """QuadLight::isIntersection (Light.cpp:228-233): two triangles
    (v0,v1,v3) and (v2,v3,v1)."""
    h1, t1 = _intersect_triangle_any(o, d, verts[0], verts[1], verts[3])
    h2, t2 = _intersect_triangle_any(o, d, verts[2], verts[3], verts[1])
    # C++ short-circuit ||: t keeps the FIRST triangle's value when both
    # hit (coplanar disjoint halves -> at most one true hit anyway)
    return h1 | h2, np.where(h1, t1, t2)


# ---------------------------------------------------------------------------
# Sampling (Bsdf.cpp:96-132, Math.cpp:16-24)
# ---------------------------------------------------------------------------

def concentric_sample_disk(randoms):
    off = 2.0 * randoms - 1.0
    zero = (off[:, 0] == 0.0) & (off[:, 1] == 0.0)
    use_x = np.abs(off[:, 0]) > np.abs(off[:, 1])
    safe = lambda a: np.where(a == 0.0, 1.0, a)
    r = np.where(use_x, off[:, 0], off[:, 1])
    theta = np.where(use_x,
                     (np.pi / 4.0) * (off[:, 1] / safe(off[:, 0])),
                     (np.pi / 2.0) - (np.pi / 4.0) * (off[:, 0] / safe(off[:, 1])))
    pt = r[:, None] * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    return np.where(zero[:, None], 0.0, pt)


def cosine_sample_hemisphere(s):
    d = concentric_sample_disk(s)
    z = np.sqrt(np.maximum(0.0, 1.0 - d[:, 0] ** 2 - d[:, 1] ** 2))
    return np.stack([d[:, 0], d[:, 1], z], axis=-1)


def local_to_world_normal(vec, n):
    dx0 = np.stack([np.zeros_like(n[:, 0]), n[:, 2], -n[:, 1]], axis=-1)
    dx1 = np.stack([-n[:, 2], np.zeros_like(n[:, 0]), n[:, 0]], axis=-1)
    s = _normalize(np.where((n[:, 1] ** 2 > n[:, 0] ** 2)[:, None], dx0, dx1))
    t = _normalize(np.cross(n, s))
    return vec[:, 0:1] * s + vec[:, 1:2] * t + vec[:, 2:3] * n


# ---------------------------------------------------------------------------
# Lambertian BSDF (Bsdf.cpp:179-209)
# ---------------------------------------------------------------------------

def lambert_sample(diffuse, ray_in, normal, sample):
    """BSDF::sample guard + LambertianReflectionBSDF::localSample.
    Returns (reflectance [R,3], out_dir [R,3], pdf [R])."""
    entering = _dot(ray_in, normal) > 0.0
    hemi = cosine_sample_hemisphere(sample)
    hemi = np.where(entering[:, None], hemi, -hemi)
    out = local_to_world_normal(hemi, normal)
    pdf = np.abs(_dot(out, normal)) / np.pi
    refl = diffuse / np.pi
    bad = (_dot(ray_in, normal) == 0.0) | (pdf == 0.0)
    refl = np.where(bad[:, None], 0.0, refl)
    return refl, out, pdf


def lambert_evaluate_light(diffuse, normal, in_dir, out_dir):
    reflect = _dot(in_dir, normal) * _dot(out_dir, normal) > 0.0
    return np.where(reflect[:, None], diffuse / np.pi, 0.0)


# ---------------------------------------------------------------------------
# Quad light (Light.cpp:236-300, Light.h:70-73)
# ---------------------------------------------------------------------------

def quad_light_sample_dir(light, sample_pos, u):
    """QuadLight::calcLightdir(randomize=True). Returns (unnormalized
    light_dir [R,3], attenuation [R])."""
    v = light["verts"]
    x1 = v[0][None] + u[:, 0:1] * (v[1] - v[0])[None]
    x2 = v[3][None] + u[:, 0:1] * (v[2] - v[3])[None]
    interpol = x1 + u[:, 1:2] * (x2 - x1)
    light_dir = interpol - sample_pos
    dd = np.clip(_dot(_normalize(-light_dir), light["direction"][None]), 0.0, 1.0)
    dist = np.linalg.norm(light_dir, axis=-1)
    c, l, q = light["const_att"], light["lin_att"], light["quad_att"]
    use = (c > 0.0) or (l > 0.0 and q > 0.0)
    att_d = 1.0 / (c + l * dist + q * dist * dist) if use else np.ones_like(dist)
    return light_dir, dd * att_d


def quad_light_emitted(light, ray_dir):
    """QuadLight::sampleLightSource (Light.cpp:236-240)."""
    facing = _dot(_normalize(-ray_dir), light["direction"][None]) >= 0.0
    cdiv = light["const_att"] if light["const_att"] > 0 else 1.0
    return (1.0 / np.pi) * facing[:, None] * light["color"][None] / cdiv


# ---------------------------------------------------------------------------
# The renderer (SimpleShader.h:31-152 + CPU_PathTracer.cpp:61-211)
# ---------------------------------------------------------------------------

def render_pt(scene, cam, uniforms, spp, depth):
    """Progressive path trace -> [H, W, 3] float64.

    scene: dict with v0/v1/v2 [T,3], n0/n1/n2 [T,3] (per-vertex normals),
    mat_id [T], diffuse [M,3], emission [M,3], lights: list of quad dicts
    (verts [4,3], color [3], direction [3], const/lin/quad_att floats),
    env_color [3], env_ambient [3].
    uniforms: callable (sample_idx, bounce, tag, n) -> [R, n] float64 —
    tags match the JAX renderer's streams (0 bsdf 2D, 1 light pick,
    2 light point 2D; bounce -1 tag 7 = camera jitter).
    """
    w, h = cam["resolution"]
    r = w * h
    px = np.arange(r, dtype=F) % w
    py = np.arange(r, dtype=F) // w
    accum = np.zeros((r, 3), F)

    for s in range(spp):
        jitter = uniforms(s, -1, 7, 2)
        o, d = primary_rays(cam, px, py, jitter)
        color = np.zeros((r, 3), F)
        radiance = np.ones((r, 3), F)

        for b in range(depth):
            alive = np.any(radiance != 0.0, axis=-1)
            t, tri, bary = closest_triangle_hit(o, d, scene["v0"],
                                                scene["v1"], scene["v2"])
            # analytic light intersections (traceRay:185-208)
            t_light = np.full(r, FLT_MAX)
            light_idx = np.full(r, -1, np.int64)
            for li, light in enumerate(scene["lights"]):
                hit_l, tl = quad_light_hit(o, d, light["verts"])
                better = hit_l & (tl < t_light)
                t_light = np.where(better, tl, t_light)
                light_idx = np.where(better, li, light_idx)
            light_wins = t_light < t

            miss = alive & (t == FLT_MAX) & ~light_wins
            hit_light = alive & light_wins
            hit_geom = alive & (t < FLT_MAX) & ~light_wins

            # EnvironmentShader (EnvironmentShader.h:21-28)
            color += np.where(miss[:, None],
                              scene["env_color"][None] * radiance, 0.0)
            # LightShader (LightShader.h:20-26)
            lrad = np.zeros((r, 3), F)
            for li, light in enumerate(scene["lights"]):
                sel = hit_light & (light_idx == li)
                lrad = np.where(sel[:, None], quad_light_emitted(light, d),
                                lrad)
            color += np.where(hit_light[:, None], lrad * radiance, 0.0)
            radiance = np.where((miss | hit_light)[:, None], 0.0, radiance)

            # SimpleShader::shade on geometry hits
            pos = o + t[:, None] * d
            n0 = scene["n0"][tri]
            n1 = scene["n1"][tri]
            n2 = scene["n2"][tri]
            normal = _normalize(bary[:, 0:1] * n0 + bary[:, 1:2] * n1
                                + bary[:, 2:3] * n2)  # Triangle.cpp:244-248
            diffuse = scene["diffuse"][scene["mat_id"][tri]]
            emission = scene["emission"][scene["mat_id"][tri]]
            counter = -_normalize(d)

            u_bsdf = uniforms(s, b, 0, 2)
            u_pick = uniforms(s, b, 1, 1)[:, 0]
            u_light = uniforms(s, b, 2, 2)

            direct = _calc_direct_light(scene, pos, normal, diffuse, d,
                                        u_pick, u_light, hit_geom)
            ambient = (scene["env_ambient"][None]
                       * lambert_evaluate_light(diffuse, normal, normal,
                                                normal) / np.pi)
            accumulated = (direct + ambient) * radiance

            refl, out_dir, pdf = lambert_sample(diffuse, counter, normal,
                                                u_bsdf)
            kill = (np.all(refl == 0.0, axis=-1) | (pdf <= 1e-4)
                    | (np.max(radiance, axis=-1) < 0.01))
            # Cornell scope: no emissive BSDF -> is_emissive_bounce false

            new_radiance = radiance * refl * (
                np.abs(_dot(out_dir, normal)) / np.where(pdf == 0, 1.0, pdf)
            )[:, None]
            offset = 1e-4 * _faceforward(-normal, normal, out_dir)
            new_o = pos + offset
            # Ray ctor normalizes; Lambert out_dir is already unit

            color += np.where(hit_geom[:, None], accumulated, 0.0)
            radiance = np.where(hit_geom[:, None],
                                np.where(kill[:, None], 0.0, new_radiance),
                                radiance)
            cont = hit_geom & ~kill
            o = np.where(cont[:, None], new_o, o)
            d = np.where(cont[:, None], out_dir, d)

        # drawTexture running mean (CPU_PathTracer.cpp:68-79)
        accum += (color - accum) / (s + 1)

    return accum.reshape(h, w, 3)


def _calc_direct_light(scene, pos, normal, diffuse, ray_dir, u_pick,
                       u_light, active):
    """SimpleShader::calcDirectLight (SimpleShader.h:101-152), one
    uniformly picked light, NO 1/N compensation."""
    r = pos.shape[0]
    n_lights = len(scene["lights"])
    if n_lights == 0:
        return np.zeros((r, 3), F)
    pick = np.minimum((u_pick * n_lights).astype(np.int64), n_lights - 1)
    out = np.zeros((r, 3), F)
    for li, light in enumerate(scene["lights"]):
        sel = active & (pick == li)
        light_dir, att = quad_light_sample_dir(light, pos, u_light)
        lightpos = pos + light_dir
        origin = pos + 1e-4 * _faceforward(normal, pos - lightpos, normal)
        wi = _normalize(light_dir)
        f = lambert_evaluate_light(diffuse, normal, wi, -ray_dir)
        contrib = (light["color"][None] * att[:, None] * f
                   * np.abs(_dot(wi, normal))[:, None])
        t_max = np.linalg.norm(lightpos - origin, axis=-1)
        # scene occlusion (brute force = NoDataStructure oracle)
        t, _, _ = closest_triangle_hit(origin, wi, scene["v0"],
                                       scene["v1"], scene["v2"])
        blocked = t < t_max
        # light geometry also occludes (SimpleShader.h:135-144)
        for other in scene["lights"]:
            hit_l, tl = quad_light_hit(origin, wi, other["verts"])
            blocked |= hit_l & (tl < t_max)
        has_color = np.any(light["color"] > 0.0)
        out = np.where((sel & has_color & ~blocked)[:, None], contrib, out)
    return out
