"""Bidirectional path tracing: light-subpath buffer + eye-vertex connection
+ camera-plane splat.

Wavefront re-design of the reference GPU pipeline's BDPT side-channel:
  * light bounce buffer construction — per (sample, light) emit a photon ray
    by light kind and walk it `n_bounces` vertices through the scene,
    recording position / incoming direction / path throughput
    (/root/reference/src/shaders/compute/Pathtracer/lbb_construction.compute:
    34-141 calcLightBounce per kind, :300-402 shadeLightRays walk; the
    construction overwrites the per-kind emission weight with 1/pi at :231 —
    kept for parity).
  * eye-vertex connection — each eye hit picks one (sample, light) subpath
    and connects to ALL its vertices with shadow rays, weighting each
    connection by 1/(j + 1 + eye_bounce)
    (pt_shade.compute:146-201; distance attenuation is disabled there
    [attenuation = 1, :175] and the geometry term is commented out — kept).
  * image-plane splat — light vertices are connected straight to the camera
    plane with the W_e = 1/(A cos^4 theta) sensor importance and t^2/cos
    density conversion (shadeBDPTImagePlane, pt_shade.compute:17-97).

Here the buffer is a [P, B] SoA pytree (P = samples_per_light * n_lights),
the walk is a python loop over the small static bounce count (each step one
wavefront closest-hit sweep), and both connection kernels are branchless
masked sums.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, sampling as sp, vecmath as vm
from ..ops import intersect as isect, traverse
from ..scene.types import (
    DeviceScene, LightPack,
    LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT, LIGHT_SUN,
    MATFLAG_EMISSIVE_BOUNCE,
)
from . import bsdf as bsdf_mod

INV_PI = 1.0 / jnp.pi


class LightSubpaths(NamedTuple):
    """[P, B] light-subpath vertex buffer (LightBounce SoA,
    lbb_construction.compute:7-19)."""

    position: jnp.ndarray  # [P,B,3] vertex position (j=0: emission origin)
    in_dir: jnp.ndarray  # [P,B,3] direction of the ray arriving at the vertex
    hit_color: jnp.ndarray  # [P,B,3] path throughput (starts at 1/pi)
    travel: jnp.ndarray  # [P,B] cumulative distance (base_color.a)
    valid: jnp.ndarray  # [P,B]
    light_index: jnp.ndarray  # [P] int32


def emit_light_rays(lights: LightPack, idx, u1, u2):
    """calcLightBounce per light kind -> (origin, direction) of the photon
    ray (lbb_construction.compute:34-141)."""
    kind = lights.kind[idx]
    pos = lights.position[idx]
    ldir = lights.direction[idx]
    radius = lights.radius[idx]

    # point: sphere-normal origin, cosine direction about that normal
    n_sph = sp.uniform_sphere_sample(u1)
    o_point = pos + n_sph * radius[:, None]
    d_point = sp.cosine_hemisphere_about(u2, n_sph)

    # sun: origin pushed to 1e16 opposite the direction, ray = direction
    rand_pt = sp.uniform_sphere_sample(u1) * radius[:, None] - ldir
    o_sun = rand_pt + 1e16 * vm.normalize(rand_pt)
    d_sun = ldir

    # spot: disk origin about the axis, cone direction within outer angle
    disk = sp.sample_disk_about(u1, ldir, radius)
    o_spot = pos + disk
    d_spot = vm.local_to_world_normal(
        sp.sample_angle(u2, jnp.radians(lights.outer_angle[idx])), ldir)

    # quad: bilinear area point, cosine direction about the quad normal
    v = lights.verts[idx]
    x1 = v[:, 0] + u1[:, 0:1] * (v[:, 1] - v[:, 0])
    x2 = v[:, 3] + u1[:, 0:1] * (v[:, 2] - v[:, 3])
    o_quad = x1 + u1[:, 1:2] * (x2 - x1)
    d_quad = sp.cosine_hemisphere_about(u2, ldir)

    o = jnp.where((kind == LIGHT_POINT)[:, None], o_point,
        jnp.where((kind == LIGHT_QUAD)[:, None], o_quad,
        jnp.where((kind == LIGHT_SPOT)[:, None], o_spot, o_sun)))
    d = jnp.where((kind == LIGHT_POINT)[:, None], d_point,
        jnp.where((kind == LIGHT_QUAD)[:, None], d_quad,
        jnp.where((kind == LIGHT_SPOT)[:, None], d_spot, d_sun)))
    return o, vm.normalize(d)


def angular_attenuation(lights: LightPack, idx, dir_to_light):
    """inc_light.compute:207-237 — spot falloff / quad facing; 1 otherwise."""
    kind = lights.kind[idx]
    d = vm.normalize(-dir_to_light)
    cosd = vm.dot(d, lights.direction[idx])
    angle = jnp.degrees(jnp.arccos(jnp.clip(cosd, -1.0 + 1e-7, 1.0 - 1e-7)))
    inner = lights.inner_angle[idx]
    outer = lights.outer_angle[idx]
    spot = 1.0 - jnp.clip((angle - inner) / jnp.maximum(outer - inner, 1e-6),
                          0.0, 1.0)
    return jnp.where(kind == LIGHT_SPOT, spot,
           jnp.where(kind == LIGHT_QUAD, cosd, 1.0))


def build_light_subpaths(scene: DeviceScene, key, samples_per_light: int,
                         n_bounces: int, ray_chunk: int = 8192,
                         occlude_fn=None, closest_fn=None) -> LightSubpaths:
    """Construct the light bounce buffer: emit P photon rays, walk each
    `n_bounces` vertices (traceLightRays + shadeLightRays fused per step)."""
    lights = scene.lights
    n_l = lights.count
    p = samples_per_light * n_l
    light_index = jnp.tile(jnp.arange(n_l, dtype=jnp.int32), samples_per_light)

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(p))
    u1 = rng.bounce_uniform(keys, -1, 2, tag=10)
    u2 = rng.bounce_uniform(keys, -1, 2, tag=11)
    o0, d0 = emit_light_rays(lights, light_index, u1, u2)

    positions = [o0]
    in_dirs = [d0]
    hit_colors = [jnp.full((p, 3), INV_PI)]  # lbb_construction.compute:231
    travels = [jnp.zeros((p,))]
    valids = [jnp.ones((p,), bool)]

    o, d = o0, d0
    hc = hit_colors[0]
    travel = travels[0]
    alive = valids[0]
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)

    for j in range(1, n_bounces):
        if closest_fn is None:
            hit = traverse.closest_hit(o, d, scene, chunk=ray_chunk)
        else:
            hit = closest_fn(o, d, scene)
        v3 = hit.valid[:, None]
        pos_j = jnp.where(v3, hit.position, o)
        norm_j = jnp.where(v3, hit.normal, up)
        travel = travel + jnp.where(hit.valid, vm.length(pos_j - o), 0.0)

        mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv,
                                       scene.textures, scene.tex_slots)
        u_b = rng.bounce_uniform(keys, j, 2, tag=12)
        bs = bsdf_mod.sample_surface(mp, -d, norm_j, u_b,
                                     jnp.zeros((p,), jnp.int32),
                                     present=scene.bsdfs_present)
        # hit_color *= reflectance * clamp(|cos|*pdf, 0, 1)
        # (lbb_construction.compute:344-346)
        w = jnp.clip(jnp.abs(vm.dot(bs.wo, norm_j)) * bs.pdf, 0.0, 1.0)
        hc_j = hc * bs.reflectance * w[:, None]

        emissive = (bs.flags & MATFLAG_EMISSIVE_BOUNCE) != 0
        dead = (~hit.valid) | emissive | (bs.pdf <= 1e-4) | \
            jnp.all(hc_j == 0.0, axis=-1)
        alive_j = alive & ~dead

        positions.append(pos_j)
        in_dirs.append(vm.normalize(d))
        hit_colors.append(hc_j)
        travels.append(travel)
        # vertex j itself is usable if the walk reached it and the HIT is
        # real (emissive/zero only stop the NEXT segment in the reference
        # after the current vertex was already shaded — but it also marks
        # the current slot dead on miss/emissive, :364-383)
        valids.append(alive & hit.valid & ~emissive)

        o = pos_j + 1e-4 * bs.wo
        d = bs.wo
        hc = hc_j
        alive = alive_j

    return LightSubpaths(
        position=jnp.stack(positions, axis=1),
        in_dir=jnp.stack(in_dirs, axis=1),
        hit_color=jnp.stack(hit_colors, axis=1),
        travel=jnp.stack(travels, axis=1),
        valid=jnp.stack(valids, axis=1),
        light_index=light_index,
    )


def connect_eye_vertex(scene: DeviceScene, sub: LightSubpaths,
                       u_pick,  # [R,2]
                       pos, normal, view_dir, mp, bounce,
                       bias: float = 1e-4, ray_chunk: int = 8192,
                       occlude_fn=None):
    """BDPT connection at an eye hit (pt_shade.compute:146-201): pick one
    (sample, light) subpath per ray, connect to each of its vertices.
    Returns the direct-light replacement term [R,3] (caller multiplies by
    throughput is NOT needed — matches the reference which multiplies by
    light_weight; here the caller applies radiance itself)."""
    lights = scene.lights
    p_total, n_b = sub.valid.shape
    n_l = lights.count
    s_total = p_total // n_l
    r = pos.shape[0]

    s_pick = jnp.minimum((u_pick[:, 0] * s_total).astype(jnp.int32), s_total - 1)
    l_pick = jnp.minimum((u_pick[:, 1] * n_l).astype(jnp.int32), n_l - 1)
    pidx = s_pick * n_l + l_pick

    lidx = sub.light_index[pidx]
    base_color = lights.color[lidx]
    total = jnp.zeros((r, 3))

    for j in range(n_b):
        v_pos = sub.position[pidx, j]
        v_in = sub.in_dir[pidx, j]
        v_hc = sub.hit_color[pidx, j]
        v_ok = sub.valid[pidx, j]

        light_pos = v_pos - bias * v_in
        to_light = light_pos - pos
        sdir = vm.normalize(to_light)
        t_max = vm.length(to_light)

        lc = jnp.where(jnp.full((r,), j == 0)[:, None],
                       angular_attenuation(lights, lidx, to_light)[:, None] * base_color,
                       base_color)

        origin = pos + bias * normal
        if occlude_fn is None:
            blocked = traverse.any_hit(origin, sdir, scene, t_max,
                                       chunk=ray_chunk)
        else:
            blocked = occlude_fn(origin, sdir, scene, t_max)
        t_l, valid_l = isect.light_hit_grid(origin, sdir, lights)
        blocked |= jnp.any(valid_l & (t_l < t_max[:, None]), axis=-1)

        f = bsdf_mod.evaluate_light(mp, normal, sdir, -vm.normalize(view_dir))
        contrib = (v_hc * lc * f *
                   jnp.abs(vm.dot(sdir, normal))[:, None] /
                   (j + 1.0 + bounce))
        total = total + jnp.where((v_ok & ~blocked)[:, None], contrib, 0.0)
    return total


def splat_image_plane(scene: DeviceScene, camera, sub: LightSubpaths,
                      pixel_ids, keys, ray_chunk: int = 8192,
                      occlude_fn=None):
    """shadeBDPTImagePlane (pt_shade.compute:17-97): connect light vertices
    straight to jittered points on the camera plane. Returns [R,3] additive
    color for the given pixels."""
    lights = scene.lights
    w, h = camera.resolution
    p_total, n_b = sub.valid.shape
    n_l = lights.count
    s_total = p_total // n_l
    r = pixel_ids.shape[0]

    jitter = rng.bounce_uniform(keys, -1, 2, tag=13)
    u_pick = rng.bounce_uniform(keys, -1, 2, tag=14)
    px = (pixel_ids % w).astype(jnp.float32) + jitter[:, 0]
    py = (pixel_ids // w).astype(jnp.float32) + jitter[:, 1]
    ax = camera.pixel_size * camera.axis_x
    ay = camera.pixel_size * camera.axis_y
    pixel = camera.bottom_left[None, :] + px[:, None] * ax + py[:, None] * ay

    # sensor-plane area + normal (pt_shade.compute:55-62)
    area = float(w) * float(h) * jnp.linalg.norm(jnp.cross(
        camera.pixel_size * camera.axis_y, camera.pixel_size * camera.axis_x))
    cam_n = vm.normalize(jnp.cross(camera.axis_y, camera.axis_x))

    s_pick = jnp.minimum((u_pick[:, 0] * s_total).astype(jnp.int32), s_total - 1)
    l_pick = jnp.minimum((u_pick[:, 1] * n_l).astype(jnp.int32), n_l - 1)
    pidx = s_pick * n_l + l_pick

    total = jnp.zeros((r, 3))
    for j in range(n_b):
        v_pos = sub.position[pidx, j]
        v_in = sub.in_dir[pidx, j]
        v_hc = sub.hit_color[pidx, j]
        v_ok = sub.valid[pidx, j]

        target = v_pos + 1e-4 * v_in
        d = target - pixel
        t = vm.length(d)
        dn = d / jnp.maximum(t, 1e-12)[:, None]

        cos_t = vm.dot(cam_n[None, :], dn)
        we = 1.0 / jnp.maximum(area * cos_t ** 4, 1e-12)
        we = jnp.where(cos_t <= 0.0, 0.0, we)
        npdf = (t * t) / jnp.maximum(jnp.abs(cos_t), 1e-12)

        if occlude_fn is None:
            blocked = traverse.any_hit(pixel, dn, scene, t, chunk=ray_chunk)
        else:
            blocked = occlude_fn(pixel, dn, scene, t)
        t_l, valid_l = isect.light_hit_grid(pixel, dn, lights)
        blocked |= jnp.any(valid_l & (t_l < t[:, None]), axis=-1)

        contrib = v_hc * (we / jnp.maximum(npdf, 1e-12) / (j + 1.0))[:, None]
        total = total + jnp.where((v_ok & ~blocked)[:, None], contrib, 0.0)
    return total
