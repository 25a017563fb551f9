"""Whitted raytracer with single-pass closed-form Marschner fur.

Wavefront re-design of KIRK::CPU::SimpleCPURaytracer
(/root/reference/src/libraries/KIRK/CPU/CPU_Raytracer/Simple_CPU_Raytracer.cpp):
the reference recursion (trace -> shade -> {refraction, reflection} children,
Simple_CPU_Raytracer.cpp:55-107,356-449) is a binary tree of weighted rays.
Because the reference combines child colors with `mix` (affine in each
child), the tree linearizes exactly: every node carries an accumulated color
weight, local shading is scaled by it, and the recursion is evaluated as a
lock-step per-ray DEPTH-FIRST walk — each ray holds its current tree node
plus a [depth]-entry stack of deferred siblings (binary-tree DFS never holds
more than one sibling per level), and a `lax.while_loop` traces one
wavefront of current nodes per iteration. Iteration count is the largest
per-ray tree's node count — the Minweight gate (:107,228) prunes most
branches — NOT the 2^depth of a breadth-first expansion, which is what
makes the reference's default depth 8 (CPU_Raytracer.h:75) practical on a
wavefront machine.

Parity notes:
  * lightShading: ALL lights each hit (not NEE-sampled), Phong diffuse +
    specular with shininess = 1/max(roughness,1e-3) (Material.h:119),
    ambient = env_ambient * diffuse, hard shadow rays with bias 1e-2 along
    the view-flipped normal and isIntersection(t<1) against the unnormalized
    to-light direction (:80-180).
  * shade(): fresnel = clamp(refl^2 - transp^2 + r_theta*refl, 0, 1) with
    the hardcoded 1.56 ior Schlick r_theta (:540-545); refraction spawns
    with weight volume*transparency and falls back to reflection on total
    internal reflection (:212-235); reflection spawns with weight
    specular*fresnel; both gated by Minweight=0.01 (CVK_Defs.h:67) and
    level < depth.
  * shadeMarschnerHair: final color is the R lobe ONLY — TT and TRT are
    computed but commented out of the sum in the reference (:755). Default
    reproduces that; hair_lobes="all" adds TT+TRT using REAL second-wall
    normals traced through the accel structure (:575-585), like the
    reference's computation of those lobes.
  * background: environment color at any depth (:77).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import camera as cam_mod, sampling, vecmath as vm
from ..scene.types import DeviceScene
from ..ops import traverse
from . import bsdf as bsdf_mod, fur, shading

MINWEIGHT = 0.01  # CVK_Defs.h:67
RAY_EPS = 1e-4  # Ray.h:9


class WhittedConfig(NamedTuple):
    depth: int = 8  # recursion depth — reference default (CPU_Raytracer.h:75);
    #                 the DFS queue makes depth 8 cost ~tree-size, not 2^8
    supersamples: int = 1  # N×N subpixel grid (superSampling, :252-280)
    hair_lobes: str = "r"  # "r" (reference parity, :755) | "all" (R+TT+TRT)
    shadows: bool = True
    reflections: bool = True  # RTFLAG_USE_REFLECTIONS
    refractions: bool = True  # RTFLAG_USE_REFRACTIONS
    soft_shadows: bool = False  # RTFLAG_SOFT_SHADOWS: jittered shadow rays
    #   toward light-sphere/area samples (Ray::jitterBy + randomized
    #   calcLightdir, Light.cpp:127-159)
    shadow_samples: int = 4  # visibility samples per light when soft
    dof: bool = False  # RTFLAG_USE_DOF: replace each primary ray by
    #   dof_samples thin-lens rays averaged (depthOfField,
    #   Simple_CPU_Raytracer.cpp:236-248); needs camera.use_dof for the
    #   aperture/focus parameters. Like the reference, DoF consumes one
    #   recursion level (trace(level+1), :246).
    dof_samples: int = 4  # m_num_blursamples
    aa: str = "grid"  # subpixel pattern: "grid" | "poisson"
    #   (PoissonDiskGenerator AA, Simple_CPU_Raytracer.h:26)
    adaptive: bool = False  # RTFLAG_USE_ADAPTIVE_SAMPLING: per-pixel
    #   quadtree corner refinement (adaptiveSampling,
    #   Simple_CPU_Raytracer.cpp:275-341); active when supersamples == 1,
    #   matching the reference's else-if flag order (:30-38)
    adaptive_threshold: float = 0.5  # m_max_adaptive_difference (:10)
    adaptive_depth: int = 2  # m_adaptive_depth (:9)
    ray_chunk: int = 16384


def _norm_view_flip(norm, view):
    """Flip the normal toward the viewer (:97-103 / :371-376)."""
    m_dot = vm.dot(norm, view)
    flip = jnp.abs(m_dot) >= 1e-5
    flipped = -vm.normalize(m_dot[:, None] * norm)
    return jnp.where(flip[:, None], flipped, norm)


def _light_target_deterministic(lights, i, pos):
    """calcLightdir(randomize=False) for light i: point/spot/quad aim at the
    light position, sun at pos - direction * 1e16 (infinitely far opposite
    its direction, Light.cpp:463-475)."""
    kind = lights.kind[i]
    lp = lights.position[i]
    ld = lights.direction[i]
    sun_target = pos - ld[None] * 1e16
    return jnp.where(kind == 3, sun_target, jnp.broadcast_to(lp, pos.shape))


def light_shading(scene: DeviceScene, pos, norm, uv, view, mp, diff_color,
                  cfg: WhittedConfig, key=None, n_alive=None, active=None):
    """SimpleCPURaytracer::lightShading (:80-180). Hard shadows by default;
    cfg.soft_shadows averages `shadow_samples` jittered visibility rays per
    light (randomized calcLightdir + jitterBy semantics).

    `active` [R] bool: lanes that actually shade. Dead lanes get t_max=0
    shadow rays — required for correctness, not just speed: any_hit's
    octant sort keys dead rays by t_max <= 0, and an all-ones t_max would
    scatter live shadow rays past the n_alive chunk gate (silently
    unblocked shadows on compacted wavefronts > ray_chunk)."""
    lights = scene.lights
    color = scene.env.ambient * diff_color  # ambient part (:88)
    norm_view = _norm_view_flip(norm, view)
    shininess = 1.0 / jnp.maximum(mp.roughness, 1e-3)
    shadow_t = (jnp.ones(pos.shape[0]) if active is None
                else jnp.where(active, 1.0, 0.0))

    for i in range(lights.count):
        target = _light_target_deterministic(lights, i, pos)
        ldir = target - pos
        n_ldir = vm.normalize(ldir)
        dist = vm.length(ldir)
        idx = jnp.full((pos.shape[0],), i, jnp.int32)
        att = shading.distance_attenuation(lights, idx, dist)
        # per-kind angular attenuation (Light.cpp calcLightdir non-random);
        # light->point direction is -n_ldir.
        kind = lights.kind[i]
        laxis = lights.direction[i][None]
        dd = jnp.clip(vm.dot(-n_ldir, laxis), 0.0, 1.0)
        ang = jnp.degrees(jnp.arccos(jnp.clip(vm.dot(-n_ldir, laxis), -1.0, 1.0)))
        inner, outer = lights.inner_angle[i], lights.outer_angle[i]
        delta = (1.0 - jnp.clip((ang - inner) / jnp.maximum(outer - inner, 1e-6),
                                0.0, 1.0)) ** 4
        att = jnp.where(kind == 1, att * dd,  # quad faces the point
              jnp.where(kind == 2, att * delta, att))  # spot falloff
        facing = vm.dot(norm_view, n_ldir) >= 0.0
        lit = (att > 0.0) & facing

        cos_phi = jnp.maximum(vm.dot(norm, n_ldir), 0.0)
        direct = cos_phi[:, None] * diff_color * lights.color[i] * att[:, None]
        refl = vm.reflect(n_ldir, norm)
        cos_psi = jnp.maximum(vm.dot(refl, view), 0.0) ** shininess
        direct = direct + (mp.reflectivity * cos_psi)[:, None] * mp.specular \
            * lights.color[i] * att[:, None]
        direct = jnp.where(lit[:, None], direct, 0.0)

        if cfg.shadows:
            origin = pos + 1e-2 * norm_view
            if cfg.soft_shadows and key is not None:
                # average visibility over jittered light samples: point/spot
                # jitter within the light sphere radius, quads within their
                # equivalent-area radius, suns within an angular disk (the
                # 1e16-distant target scaled accordingly).
                ns = max(1, cfg.shadow_samples)
                scale = jnp.where(kind == 3, 1e14, 1.0) * \
                    jnp.maximum(lights.radius[i], 1e-3)
                lkey = jax.random.fold_in(key, i)
                vis = jnp.zeros((pos.shape[0],), jnp.float32)
                for s in range(ns):
                    u = jax.random.uniform(jax.random.fold_in(lkey, s),
                                           (pos.shape[0], 3))
                    sphere = sampling.uniform_sphere_sample(u[:, :2]) \
                        * (u[:, 2:] ** (1.0 / 3.0))
                    sdir = target + scale * sphere - origin
                    blocked = traverse.any_hit(
                        origin, sdir, jax.lax.stop_gradient(scene),
                        shadow_t, chunk=cfg.ray_chunk,
                        n_alive=n_alive)
                    vis = vis + jnp.where(blocked, 0.0, 1.0 / ns)
                direct = direct * vis[:, None]
            else:
                sdir = target - origin
                blocked = traverse.any_hit(origin, sdir,
                                           jax.lax.stop_gradient(scene),
                                           shadow_t,
                                           chunk=cfg.ray_chunk,
                                           n_alive=n_alive)
                direct = jnp.where(blocked[:, None], 0.0, direct)
        color = color + direct
    return color


def _hair_color(scene, hit, view_n, mp, cfg: WhittedConfig):
    """shadeMarschnerHair (:451-760) — closed-form lobes, with real traced
    second/third-wall normals when hair_lobes='all'."""
    nin = view_n  # normalized incoming ray direction
    normal = hit.normal
    if cfg.hair_lobes == "all":
        sg = jax.lax.stop_gradient
        nf = vm.faceforward(normal, -nin, normal)
        ior = mp.ior[:, None]
        t_dir = vm.refract(-nin, nf, 1.0 / ior)
        t_hit = traverse.closest_hit(hit.position + 1e-4 * t_dir, t_dir,
                                     sg(scene), chunk=cfg.ray_chunk)
        t_normal = jnp.where(t_hit.valid[:, None], t_hit.normal, normal)
        t_pos = jnp.where(t_hit.valid[:, None], t_hit.position, hit.position)
        t_nf = vm.faceforward(t_normal, -vm.normalize(t_dir), t_normal)
        tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
        tr_hit = traverse.closest_hit(t_pos + 1e-4 * tr_dir, tr_dir,
                                      sg(scene), chunk=cfg.ray_chunk)
        tr_normal = jnp.where(tr_hit.valid[:, None], tr_hit.normal, normal)
    else:
        t_normal = tr_normal = normal

    lobes = fur.marschner_closed_form(mp, nin, normal, hit.fiber_v,
                                      t_normal, tr_normal)
    if cfg.hair_lobes == "all":
        return lobes.scat_r + lobes.scat_tt + lobes.scat_trt
    return lobes.scat_r  # reference sums only R (:755)


def render_whitted(scene: DeviceScene, camera: cam_mod.Camera,
                   cfg: WhittedConfig = WhittedConfig(),
                   key=None) -> jnp.ndarray:
    """Deterministic Whitted render -> [H,W,3]. jit-able; wrap in jax.jit
    with cfg static. `key` seeds the jittered soft-shadow visibility
    samples (cfg.soft_shadows); defaults to a fixed seed so renders stay
    reproducible."""
    if key is None and cfg.soft_shadows:
        key = jax.random.PRNGKey(0)
    from ..scene.types import ensure_device
    scene = ensure_device(scene)  # while_loop bodies can't index numpy leaves
    w, h = camera.resolution
    px, py = cam_mod.pixel_grid(camera.resolution)
    r = px.shape[0]
    image = jnp.zeros((r, 3), jnp.float32)

    n_ss = max(1, cfg.supersamples)
    use_dof = cfg.dof and camera.use_dof
    n_dof = max(1, cfg.dof_samples) if use_dof else 1

    def radical2(i):
        # van-der-Corput base 2 — deterministic lens points
        x, f, b = 0.0, 0.5, i
        while b:
            x, f, b = x + f * (b & 1), f * 0.5, b >> 1
        return x

    def lens_u(s):
        if not use_dof:
            return None
        return jnp.broadcast_to(
            jnp.asarray([radical2(s), (s + 0.5) / n_dof], jnp.float32), (r, 2))

    if cfg.adaptive and n_ss == 1:
        # else-if flag order of renderPixel (Simple_CPU_Raytracer.cpp:30-38):
        # supersampling wins over adaptive when both are set. Adaptive
        # composes with DoF like the reference (trace at level 0 dispatches
        # to depthOfField): average the adaptive pass over the deterministic
        # lens samples, each starting one level deep (:246).
        for s in range(n_dof):
            image = image + _adaptive_image(
                scene, px, py, camera, cfg, dof_u=lens_u(s),
                lvl0=1 if use_dof else 0,
                key=None if key is None else jax.random.fold_in(key, s)) / n_dof
        return image.reshape(h, w, 3)

    if n_ss == 1:
        offsets = [(0.5, 0.5)]
    elif cfg.aa == "poisson":
        # blue-noise subpixel pattern (vendored PoissonDiskGenerator role,
        # Simple_CPU_Raytracer.h:26): n_ss^2 dart-throwing points
        offsets = [tuple(map(float, p))
                   for p in sampling.poisson_disk_pattern(n_ss * n_ss)]
    else:
        offsets = [((i + 0.5) / n_ss, (j + 0.5) / n_ss)
                   for j in range(n_ss) for i in range(n_ss)]

    for si, (ox, oy) in enumerate(offsets):
        jit = jnp.broadcast_to(jnp.asarray([ox, oy], jnp.float32), (r, 2))
        for s in range(n_dof):
            o, d = cam_mod.rays_from_pixels(camera, px, py, jit, lens_u(s))
            # DoF consumes one recursion level (trace(level+1), :246)
            k_sd = (None if key is None
                    else jax.random.fold_in(key, si * n_dof + s))
            image = image + _trace_queue(scene, o, d, cfg,
                                         lvl0=1 if use_dof else 0,
                                         key=k_sd) \
                / (len(offsets) * n_dof)

    return image.reshape(h, w, 3)


def _adaptive_image(scene, px, py, camera, cfg: WhittedConfig, dof_u=None,
                    lvl0: int = 0, key=None) -> jnp.ndarray:
    """Adaptive supersampling (adaptiveSampling,
    Simple_CPU_Raytracer.cpp:275-294): trace the pixel's four inset corners
    (step 1/20 from the edges), then quadtree-refine squares whose corner
    colors disagree. Wavefront form: refinement levels are statically
    unrolled to `adaptive_depth`, but each level's midpoint traces are
    compacted by the refine mask with whole-chunk skipping
    (_adaptive_square), so the traced work — like the reference's
    recursion — scales with how many pixels actually refine."""
    step = 1.0 / 20.0
    r = px.shape[0]

    def ray(jx, jy):
        jit = jnp.broadcast_to(jnp.asarray([jx, jy], jnp.float32), (r, 2))
        return cam_mod.rays_from_pixels(camera, px, py, jit, dof_u)

    # ray1=(x1,y2) ray2=(x2,y2) ray3=(x1,y1) ray4=(x2,y1)  (:280-288)
    o, d1 = ray(step, 1.0 - step)
    _, d2 = ray(1.0 - step, 1.0 - step)
    _, d3 = ray(step, step)
    _, d4 = ray(1.0 - step, step)
    tr = lambda dd: _trace_queue(scene, o, dd, cfg, lvl0=lvl0, key=key)
    c1, c2, c3, c4 = tr(d1), tr(d2), tr(d3), tr(d4)
    return _adaptive_square(scene, o, (d1, d2, d3, d4), (c1, c2, c3, c4),
                            cfg, 0, lvl0=lvl0, key=key)


def _adaptive_square(scene, o, dirs, colors, cfg: WhittedConfig, depth: int,
                     lvl0: int = 0, active=None, key=None):
    """adaptiveSamplingRecursive (Simple_CPU_Raytracer.cpp:296-341): if any
    pairwise corner-color distance exceeds the threshold, trace the five
    edge/center midpoints and recurse into the four subsquares; pixels below
    threshold keep the plain 4-corner average.

    The refinement levels are statically unrolled (XLA needs static
    shapes), but the COST is data-dependent like the reference's recursion:
    each level's midpoint wavefronts are compacted so refining pixels are
    contiguous and whole dead chunks skip tracing entirely (the same
    n_alive chunk gating the path tracer's compaction uses). `active`
    masks pixels whose parent square did not refine — their corner colors
    are garbage and must not trigger refinement."""
    d1, d2, d3, d4 = dirs
    c1, c2, c3, c4 = colors
    flat = (c1 + c2 + c3 + c4) / 4.0
    if depth >= cfg.adaptive_depth:
        return flat

    pairs = ((c1, c2), (c1, c3), (c1, c4), (c2, c3), (c2, c4), (c3, c4))
    diff = jnp.stack([jnp.linalg.norm(a - b, axis=-1) for a, b in pairs])
    refine = jnp.max(diff, axis=0) > cfg.adaptive_threshold  # [R]
    if active is not None:
        refine = refine & active

    n1 = (d1 + d2) / 2.0
    n2 = (d1 + d3) / 2.0
    n3 = (d1 + d4) / 2.0
    n4 = (d2 + d4) / 2.0
    n5 = (d3 + d4) / 2.0

    from ..ops import compact as compact_mod
    perm, n_alive = compact_mod.compaction_permutation(refine)
    inv = compact_mod.invert_permutation(perm)
    o_c = o[perm]
    act_c = refine[perm]

    kd = None if key is None else jax.random.fold_in(key, depth)

    def tr(dd):
        c = _trace_queue(scene, o_c, dd[perm], cfg, lvl0=lvl0,
                         active=act_c, n_alive=n_alive, key=kd)
        return c[inv]

    cn1, cn2, cn3, cn4, cn5 = tr(n1), tr(n2), tr(n3), tr(n4), tr(n5)

    r1 = _adaptive_square(scene, o, (d1, n1, n2, n3), (c1, cn1, cn2, cn3), cfg, depth + 1, lvl0, refine, key)
    r2 = _adaptive_square(scene, o, (n1, d2, n3, n4), (cn1, c2, cn3, cn4), cfg, depth + 1, lvl0, refine, key)
    r3 = _adaptive_square(scene, o, (n2, n3, d3, n5), (cn2, cn3, c3, cn5), cfg, depth + 1, lvl0, refine, key)
    r4 = _adaptive_square(scene, o, (n3, n4, n5, d4), (cn3, cn4, cn5, c4), cfg, depth + 1, lvl0, refine, key)
    refined = (r1 + r2 + r3 + r4) / 4.0
    return jnp.where(refine[:, None], refined, flat)


def _trace_queue(scene, o, d, cfg: WhittedConfig, lvl0: int = 0,
                 active=None, n_alive=None, key=None):
    """Lock-step per-ray DFS over the weighted recursion tree.

    Node payload = (o, d, color-weight W [R,3], scalar trace-weight w [R],
    level). W is the product of the mix factors on the path to the root
    (what the child subtree's color is multiplied by); w reproduces the
    reference's scalar `weight` argument, which both gates Minweight AND
    multiplies the child color again (`weight * trace(...)`,
    Simple_CPU_Raytracer.cpp:107,228 — a genuine quirk kept for parity).

    Per iteration every live ray traces+shades its current node; a spawned
    refraction child becomes the next current node, a spawned reflection
    child is pushed onto the ray's stack (binary DFS ⇒ stack depth ≤
    cfg.depth), and rays with no child pop their stack. The loop ends when
    every ray's stack is empty — the exact same weighted sum as the
    reference recursion, evaluated in DFS order."""
    r = o.shape[0]
    depth = cfg.depth
    dcap = max(depth, 1)
    zero3 = jnp.zeros((r, 3), jnp.float32)

    stack = {
        "o": jnp.zeros((r, dcap, 3), jnp.float32),
        "d": jnp.zeros((r, dcap, 3), jnp.float32),
        "W": jnp.zeros((r, dcap, 3), jnp.float32),
        "w": jnp.zeros((r, dcap), jnp.float32),
        "lvl": jnp.zeros((r, dcap), jnp.int32),
    }
    cur = {"o": o, "d": d, "W": jnp.ones((r, 3), jnp.float32),
           "w": jnp.ones((r,), jnp.float32),
           "lvl": jnp.full((r,), lvl0, jnp.int32)}
    slot = jnp.arange(dcap, dtype=jnp.int32)[None]  # [1, D]

    def cond(carry):
        it, color, cur, live, stack, sp = carry
        # node-count safety cap; Minweight pruning ends loops far earlier
        return (it < 2 ** (depth + 1)) & jnp.any(live)

    def body(carry):
        it, color, cur, live, stack, sp = carry
        kk = None if key is None else jax.random.fold_in(key, it)
        c, t_child, r_child, spawn_t, spawn_r = _trace_shade(
            scene, cur["o"], cur["d"], cur["W"], cur["w"], cur["lvl"],
            live, cfg, n_alive=n_alive, key=kk)
        color = color + c

        # push the reflection child when BOTH children spawned
        push = live & spawn_t & spawn_r
        mask = push[:, None] & (slot == sp[:, None])  # [R, D] one-hot at sp
        stack = {
            "o": jnp.where(mask[..., None], r_child["o"][:, None], stack["o"]),
            "d": jnp.where(mask[..., None], r_child["d"][:, None], stack["d"]),
            "W": jnp.where(mask[..., None], r_child["W"][:, None], stack["W"]),
            "w": jnp.where(mask, r_child["w"][:, None], stack["w"]),
            "lvl": jnp.where(mask, r_child["lvl"][:, None], stack["lvl"]),
        }
        sp = sp + push.astype(jnp.int32)

        # continue into a child (refraction preferred = reference call order)
        cont = live & (spawn_t | spawn_r)
        take_t = live & spawn_t
        child = {k: jnp.where(_bc(take_t, t_child[k]), t_child[k], r_child[k])
                 for k in cur}

        # no child: pop the deferred sibling, else the ray is done
        pop = ~cont & (sp > 0)
        sp = sp - pop.astype(jnp.int32)
        rows = jnp.arange(r)
        popped = {k: stack[k][rows, sp] for k in cur}

        cur = {k: jnp.where(_bc(cont, child[k]), child[k],
                            jnp.where(_bc(pop, popped[k]), popped[k], cur[k]))
               for k in cur}
        live = cont | pop
        return it + 1, color, cur, live, stack, sp

    live0 = jnp.ones((r,), bool) if active is None else active
    init = (jnp.int32(0), zero3, cur, live0, stack,
            jnp.zeros((r,), jnp.int32))
    _, color, _, _, _, _ = jax.lax.while_loop(cond, body, init)
    return color


def _bc(mask, like):
    """Broadcast a [R] mask against a [R] or [R,3] array."""
    return mask[:, None] if like.ndim == 2 else mask


def _trace_shade(scene, o, d, W, w, level, live, cfg: WhittedConfig,
                 n_alive=None, key=None):
    """One wavefront node: trace + shade. `level` is per-ray [R] int32.
    Returns (color contribution [R,3], refraction child, reflection child,
    spawn_t [R], spawn_r [R]); children are node dicts with zeroed payloads
    where not spawned."""
    live = live & jnp.any(W > 0.0, axis=-1)
    t_cap = jnp.where(live, jnp.inf, 0.0)  # dead lanes trace nothing
    hit = traverse.closest_hit(o, d, scene, t_max=t_cap, chunk=cfg.ray_chunk,
                               n_alive=n_alive)
    view = vm.normalize(d)

    # background (:77)
    env_c = shading.environment_color(scene.env, d)
    miss = live & ~hit.valid
    color = jnp.where(miss[:, None], W * env_c, 0.0)

    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv,
                                   scene.textures, scene.tex_slots)
    is_hair = (mp.shader_id == 1) & hit.valid & live
    is_surf = hit.valid & live & ~is_hair

    # --- surface shade (:356-449)
    base = light_shading(scene, hit.position, hit.normal, hit.uv, view, mp,
                         mp.diffuse, cfg, key=key, n_alive=n_alive,
                         active=is_surf)
    norm = hit.normal
    norm_view = _norm_view_flip(norm, view)

    angle = vm.angle_between(-view, norm_view)
    r_0 = ((1.0 - 1.56) / (1.0 + 1.56)) ** 2  # hardcoded 1.56 (:543)
    r_theta = r_0 + (1.0 - r_0) * (1.0 - jnp.cos(angle)) ** 5
    fresnel = jnp.clip(mp.reflectivity ** 2 - mp.transparency ** 2
                       + r_theta * mp.reflectivity, 0.0, 1.0)

    can_recurse = level < cfg.depth
    child_lvl = level + 1
    r = o.shape[0]
    zero_child = {"o": jnp.zeros((r, 3), jnp.float32),
                  "d": jnp.zeros((r, 3), jnp.float32),
                  "W": jnp.zeros((r, 3), jnp.float32),
                  "w": jnp.zeros((r,), jnp.float32), "lvl": child_lvl}
    t_child = dict(zero_child)
    r_child = dict(zero_child)
    spawn_t = jnp.zeros((r,), bool)
    spawn_r = jnp.zeros((r,), bool)

    if cfg.refractions:
        ft = mp.transparency * (1.0 - fresnel)
        spawn_t = is_surf & can_recurse & (ft * w > MINWEIGHT)
        eta = jnp.where(hit.enter, 1.0 / mp.ior, mp.ior)[:, None]
        refr_n = jnp.where(hit.enter[:, None], norm, -norm)
        tdir = vm.refract(view, refr_n, eta)
        tir = jnp.all(tdir == 0.0, axis=-1) | jnp.isnan(tdir[:, 0])
        # total internal reflection -> reflect instead (:230-232)
        rdir = vm.normalize(vm.reflect(view, norm_view))
        safe_t = jnp.where(tir[:, None], rdir, tdir)
        cdir = jnp.where(tir[:, None], rdir, vm.normalize(safe_t))
        corig = jnp.where(tir[:, None],
                          hit.position + 1e-2 * norm_view,
                          hit.position + RAY_EPS * cdir)
        # mix(color, volume * (1 * trace(...)), T): parent keeps (1-T);
        # refraction() is called with weight=1 (:436) so no extra scalar.
        child_W = W * mp.volume * mp.transparency[:, None]
        t_child = {"o": corig, "d": cdir,
                   "W": jnp.where(spawn_t[:, None], child_W, 0.0),
                   "w": jnp.where(spawn_t, ft, 0.0),  # falloff * 1
                   "lvl": child_lvl}
        base = jnp.where(spawn_t[:, None],
                         base * (1.0 - mp.transparency)[:, None], base)

    if cfg.reflections:
        spawn_r = is_surf & can_recurse & (fresnel * w > MINWEIGHT)
        rdir = vm.normalize(vm.reflect(view, norm_view))
        rorig = hit.position + 1e-2 * norm_view
        # mix(c1, specular * (w * trace(...)), F): the child color is scaled
        # by specular, the mix factor F, AND the scalar weight again (:107)
        child_W = W * mp.specular * (fresnel * w)[:, None]
        r_child = {"o": rorig, "d": rdir,
                   "W": jnp.where(spawn_r[:, None], child_W, 0.0),
                   "w": jnp.where(spawn_r, fresnel * w, 0.0),
                   "lvl": child_lvl}
        base = jnp.where(spawn_r[:, None], base * (1.0 - fresnel)[:, None], base)

    color = color + jnp.where(is_surf[:, None], W * base, 0.0)

    # --- hair shade
    hair_c = _hair_color(scene, hit, view, mp, cfg)
    color = color + jnp.where(is_hair[:, None], W * hair_c, 0.0)

    return color, t_child, r_child, spawn_t, spawn_r


def render_whitted_jit(scene, camera, cfg: WhittedConfig = WhittedConfig()):
    fn = jax.jit(partial(render_whitted, camera=camera, cfg=cfg))
    return fn(scene)


class HairPathRecord(NamedTuple):
    """The IntersectionTest analog (src/executables/IntersectionTest/
    main.cpp:187-236): every segment of the Marschner walk for a batch of
    rays, for file/notebook visualization instead of CVK line lists.

    Each field is [R, 2, 3] = (start, end) of a segment; `valid` masks rays
    that hit a fiber at all."""

    in_ray: jnp.ndarray  # camera ray to the first fiber hit (green)
    normal0: jnp.ndarray  # normal at first hit (blue)
    normal1: jnp.ndarray  # normal at second wall (cyan)
    out_r: jnp.ndarray  # R lobe exit (red)
    out_tt: jnp.ndarray  # TT exit at second wall (yellow)
    out_trt: jnp.ndarray  # TRT exit at first-wall re-hit (orange)
    valid: jnp.ndarray  # [R]


def record_hair_paths(scene: DeviceScene, o, d,
                      cfg: WhittedConfig = WhittedConfig(),
                      seg_len: float = 0.05) -> HairPathRecord:
    """Trace rays and record the fur R/TT/TRT walk geometry
    (getInRays/getNormalRays/getOutRays, Simple_CPU_Raytracer.h:91-101)."""
    hit = traverse.closest_hit(o, d, scene, chunk=cfg.ray_chunk)
    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv,
                                   scene.textures, scene.tex_slots)
    nin = vm.normalize(d)
    valid = hit.valid & (mp.shader_id == 1)
    normal = hit.normal
    pos = hit.position
    nf = vm.faceforward(normal, -nin, normal)

    out_r = vm.reflect(-nin, nf)
    ior = mp.ior[:, None]
    t_dir = vm.refract(-nin, nf, 1.0 / ior)
    t_hit = traverse.closest_hit(pos + 1e-4 * t_dir, t_dir, scene,
                                 chunk=cfg.ray_chunk)
    t_n = jnp.where(t_hit.valid[:, None], t_hit.normal, normal)
    t_nf = vm.faceforward(t_n, -vm.normalize(t_dir), t_n)
    out_tt = vm.refract(-vm.normalize(t_dir), t_nf, 1.0)
    tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
    tr_hit = traverse.closest_hit(t_hit.position + 1e-4 * tr_dir, tr_dir,
                                  scene, chunk=cfg.ray_chunk)
    tr_n = jnp.where(tr_hit.valid[:, None], tr_hit.normal, normal)
    tr_nf = vm.faceforward(tr_n, -vm.normalize(tr_dir), tr_n)
    out_trt = vm.refract(-vm.normalize(tr_dir), tr_nf,
                         jnp.clip(mp.ior, -1.0, 1.0)[:, None])

    def seg(start, direction):
        ln = vm.length(direction, keepdims=True)
        nd = direction / jnp.maximum(ln, 1e-12)  # zero dirs → zero segment
        return jnp.stack([start, start + seg_len * nd], 1)

    # misses leave position at o + INF*d — anchor fallbacks to the previous
    # walk point so recorded segments stay finite
    t_pos = jnp.where(t_hit.valid[:, None], t_hit.position, pos)
    tr_pos = jnp.where(tr_hit.valid[:, None], tr_hit.position, t_pos)
    return HairPathRecord(
        in_ray=jnp.stack([o, pos], axis=1),
        normal0=seg(pos, normal),
        normal1=seg(t_pos, t_n),
        out_r=seg(pos, out_r),
        out_tt=seg(t_pos, out_tt),
        out_trt=seg(tr_pos, out_trt),
        valid=valid,
    )
