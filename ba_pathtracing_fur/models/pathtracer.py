"""Wavefront progressive path tracer.

Wavefront re-design of KIRK::CPU::PathTracer
(/root/reference/src/libraries/KIRK/CPU/CPU_Raytracer/CPU_PathTracer.cpp):
the reference is already wavefront-shaped — SoA ray/bounce/hit buffers swept
bounce-synchronously by a thread pool (SURVEY §3.2). Here the wavefront is a
pytree of [R] arrays, the bounce loop is lax.fori_loop, shading is
branchless compute-all-select, and the whole sample is one fused XLA
program. Parity notes:

  * throughput starts at (1,1,1) and `radiance == 0` is THE termination
    signal (clearBufferWeights, CPU_PathTracer.cpp:112; traceRays:137).
  * lights are analytic emitters tested after scene geometry with a
    nearest-light pick (traceRay:185-208).
  * SimpleShader flow incl. its cutoffs (reflectance==0, pdf<=1e-4,
    max(throughput)<0.01 — SimpleShader.h:61-62) and its quirks (ambient =
    env_ambient * evaluateLight(n,n) / pi, no NEE pick-pdf compensation).
  * MarschnerHairShader flow: mid-walk TT/TRT bounces only move the ray
    (MarschnerHairShader.h:57-59); completed lobes scale throughput by
    3*reflectance*|cos(theta_i)| with no pdf divide (:78-82).
  * progressive accumulation is the running mean c += (new-c)/(n+1)
    (drawTexture, CPU_PathTracer.cpp:68-79).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import camera as cam_mod, pytree, rng, vecmath as vm
from ..scene.types import (
    DeviceScene,
    MATFLAG_CYLINDER_T_BOUNCE, MATFLAG_CYLINDER_TR_BOUNCE,
    MATFLAG_EMISSIVE_BOUNCE, MATFLAG_SPECULAR_BOUNCE,
    SHADER_MARSCHNER_HAIR, SHADER_SIMPLE,
)
from ..ops import bruteforce, intersect as isect, traverse
from . import bsdf as bsdf_mod, fur, shading


class RenderConfig(NamedTuple):
    depth: int = 5  # Demo default max bounces (Demo/main.cpp:209)
    spp: int = 100  # Demo default samples (Demo/main.cpp:210)
    ray_chunk: int = 8192  # memory-capping analog of BufferSegmentation
    hair_p_random: bool = False  # False = always R path (Bsdf.cpp:669 parity)
    tonemap: bool = False
    # MIS estimator (SURVEY §7 step 4 / BASELINE config 2): NEE in
    # solid-angle measure + BSDF-hit light contributions combined by the
    # power heuristic. NOT KIRK-parity — quad/point NEE uses the physical
    # Le (the same radiance a BSDF path sees on hitting the light) and the
    # uniform light pick is 1/N-compensated, so absolute brightness differs
    # from the reference's un-normalized NEE (SimpleShader.h:101-152).
    mis: bool = False
    # Russian roulette (SURVEY §7 step 4): replaces the reference's biased
    # hard cutoff max(throughput) < 0.01 (SimpleShader.h:61-62) with an
    # unbiased survival lottery from `rr_start` bounces on. A mid-fiber
    # TT/TRT walk is never rouletted (SURVEY §7 hard part b).
    rr: bool = False
    rr_start: int = 2
    # Bidirectional mode (sampling.is_bidirectional, pt_shade.compute:146):
    # NEE is replaced by connections to a per-sample light-subpath buffer,
    # plus the image-plane splat pass (shadeBDPTImagePlane).
    bdpt: bool = False
    bdpt_bounces: int = 3  # bounces_per_path
    bdpt_samples_per_light: int = 8  # samples_per_light
    bdpt_splat: bool = True
    # Stream compaction (pt_sortHits.compute:17-39 analog): permute the
    # wavefront each bounce so live rays are contiguous; whole-dead chunks
    # then skip intersection entirely (ops/compact.py + n_alive gating).
    # Exact — per-lane computation and RNG travel with the ray.
    compact: bool = True
    # Samples rendered per wavefront launch (vmapped, then averaged). At
    # small resolutions one sample's ray buffer under-fills the device;
    # batching widens the launch to spp_batch * W * H lanes.
    # Must divide spp; falls back to 1 otherwise.
    spp_batch: int = 1
    # Subpixel QMC (Hammersley set, inc_random.compute:33-46): camera
    # jitter from the Cranley–Patterson-rotated Hammersley point of the
    # sample index instead of an independent uniform per sample. Lower
    # pixel variance at equal spp; still shard-bit-identical.
    qmc: bool = False
    # Rematerialize each bounce under reverse-mode AD (jax.checkpoint on
    # the trace_bounce body): the depth-scan's AD otherwise stacks ~2k
    # internal residuals per bounce (measured via HLO dump), which balloons
    # the XLA graph the multichip train step compiles. Costs one extra
    # forward evaluation of the body in the backward sweep.
    remat: bool = False
    # Firefly ceiling: the reference's hair lobes are unbounded in the
    # 1/cos^2(theta_d) tail (Bsdf.cpp:567,661) and can reach inf, which the
    # running-mean accumulator would turn into NaN. Throughput is clamped to
    # this value after each bounce (inf-parity is not reproducible anyway).
    clamp_throughput: float = 1e4
    # Fused bounce shading: run the entire post-traversal shade stage as
    # ONE fused pass (ops/pallas/shade.py wrapping models/shade_core.py —
    # the pt_shade.compute:99-287 analog) instead of the unfused chain; on
    # small untextured triangle scenes the GPU runs the level-2 kernel,
    # which also fuses traversal and the NEE shadow test. Same estimator,
    # same RNG streams. Not compatible with bdpt (falls back) and not
    # differentiable (grad paths must use the unfused trace_bounce).
    fused_shading: bool = False
    # Run the level-2 kernel in the Pallas interpreter (tests on hosts
    # without a GPU). Only ever set explicitly.
    interpret: bool = False


@pytree.dataclass
class RayState:
    """The wavefront: Bounce{color, radiance, mat_flags} + Ray
    (CPU_PathTracer.h:23-28, 125-142) as SoA arrays."""

    origin: jnp.ndarray  # [R,3]
    direction: jnp.ndarray  # [R,3]
    radiance: jnp.ndarray  # [R,3] path throughput
    color: jnp.ndarray  # [R,3] accumulated sample color
    flags: jnp.ndarray  # [R] int32 mat_flags
    theta_i: jnp.ndarray  # [R] hair shader stash (Bsdf.cpp:516)
    prev_pdf: jnp.ndarray  # [R] solid-angle pdf of the last BSDF sample;
    # -1 = delta/camera ray (MIS weight 1 on a light hit)


def init_state(origins, directions) -> RayState:
    r = origins.shape[0]
    return RayState(
        origin=origins,
        direction=directions,
        radiance=jnp.ones((r, 3), jnp.float32),
        color=jnp.zeros((r, 3), jnp.float32),
        flags=jnp.zeros((r,), jnp.int32),
        theta_i=jnp.zeros((r,), jnp.float32),
        prev_pdf=jnp.full((r,), -1.0, jnp.float32),
    )


def trace_bounce(state: RayState, scene: DeviceScene, keys, bounce, cfg: RenderConfig,
                 closest_fn=None, occlude_fn=None, subpaths=None,
                 n_alive=None) -> RayState:
    """One wavefront bounce: trace + dispatch-shade (traceRays body).

    `closest_fn(o, d, scene)` / `occlude_fn(o, d, scene, t_max)` override the
    intersection backend (brute force by default) — the seam used by the LBVH
    path and by geometry-sharded multi-device tracing (parallel/render.py).
    """
    active = jnp.any(state.radiance != 0.0, axis=-1)
    has_dir = jnp.any(state.direction != 0.0, axis=-1)
    do_trace = active & has_dir
    t_cap = jnp.where(do_trace, isect.INF, 0.0)  # dead lanes trace nothing

    if closest_fn is None:
        hit = traverse.closest_hit(state.origin, state.direction, scene,
                                   t_max=t_cap, chunk=cfg.ray_chunk,
                                   n_alive=n_alive)
    else:
        hit = closest_fn(state.origin, state.direction, scene)

    # analytic light intersections (traceRay:185-208)
    n_lights = scene.lights.count
    if n_lights:
        t_l, valid_l = isect.light_hit_grid(state.origin, state.direction, scene.lights)
        light_idx = jnp.argmin(t_l, axis=-1).astype(jnp.int32)
        t_light = jnp.take_along_axis(t_l, light_idx[:, None], axis=-1)[:, 0]
        light_wins = t_light < hit.t
    else:
        light_idx = jnp.zeros(state.origin.shape[0], jnp.int32)
        light_wins = jnp.zeros(state.origin.shape[0], bool)

    miss = do_trace & ~hit.valid & ~light_wins
    hit_light = do_trace & light_wins
    hit_geom = do_trace & hit.valid & ~light_wins

    color = state.color
    radiance = state.radiance

    # --- EnvironmentShader (EnvironmentShader.h:21-28)
    env_c = shading.environment_color(scene.env, state.direction)
    color = color + jnp.where(miss[:, None], env_c * radiance, 0.0)

    # --- LightShader (LightShader.h:20-26)
    if n_lights:
        lrad = shading.light_emitted_radiance(scene.lights, light_idx, state.direction)
        if cfg.mis:
            # power-heuristic weight vs. the NEE strategy that could have
            # produced this same light contribution
            from ..scene.types import LIGHT_POINT, LIGHT_QUAD
            p_b = state.prev_pdf
            delta = p_b <= 0.0
            p_l = shading.light_solid_angle_pdf(
                scene.lights, light_idx, state.direction, t_light)
            kind = scene.lights.kind[light_idx]
            area_like = (kind == LIGHT_QUAD) | (kind == LIGHT_POINT)
            w = jnp.where(delta, 1.0,
                jnp.where(area_like, shading.power_heuristic(p_b, p_l), 0.0))
            lrad = lrad * w[:, None]
        color = color + jnp.where(hit_light[:, None], lrad * radiance, 0.0)

    radiance = jnp.where((miss | hit_light)[:, None], 0.0, radiance)

    # --- material shaders on geometry hits ---------------------------------
    # Sanitize hit fields for rays that missed: their normals are zero and
    # positions infinite. The shading below is masked by hit_geom, so forward
    # values don't change — but NaNs in unselected jnp.where branches poison
    # the BACKWARD pass (0 * NaN = NaN in the where VJP).
    v3 = hit.valid[:, None]
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    hit = hit.replace(
        normal=jnp.where(v3, hit.normal, up),
        position=jnp.where(v3, hit.position, 0.0),
        fiber_u=jnp.where(v3, hit.fiber_u, jnp.array([1.0, 0.0, 0.0])),
        fiber_v=jnp.where(v3, hit.fiber_v, up),
        fiber_w=jnp.where(v3, hit.fiber_w, jnp.array([0.0, 0.0, 1.0])),
    )
    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv,
                                   scene.textures, scene.tex_slots)
    counter = -vm.normalize(state.direction)
    n = hit.normal

    u_bsdf = rng.bounce_uniform(keys, bounce, 2, tag=0)
    u_pick = rng.bounce_uniform(keys, bounce, 1, tag=1)[:, 0]
    u_light = rng.bounce_uniform(keys, bounce, 2, tag=2)
    u_hairp = rng.bounce_uniform(keys, bounce, 1, tag=3)[:, 0]

    # shared NEE (both shaders use the identical calcDirectLight); in BDPT
    # mode the light-subpath connection replaces it (pt_shade.compute:146)
    if cfg.bdpt and subpaths is not None:
        from . import bdpt as bdpt_mod
        direct = bdpt_mod.connect_eye_vertex(
            scene, subpaths, u_light, hit.position, n, state.direction, mp,
            bounce, ray_chunk=cfg.ray_chunk, occlude_fn=occlude_fn)
    else:
        nee = shading.calc_direct_light_mis if cfg.mis else shading.calc_direct_light
        direct = nee(scene, mp, hit, state.direction, u_pick,
                     u_light, shadow_chunk=cfg.ray_chunk,
                     occlude_fn=occlude_fn, active=hit_geom, n_alive=n_alive)
    # ambient = env_ambient * evaluateLight(n, n) / pi (SimpleShader.h:47)
    ambient = scene.env.ambient * bsdf_mod.evaluate_light(mp, n, n, n) / jnp.pi
    accum = (direct + ambient) * radiance

    # surface BSDF sample (statically restricted to this scene's BSDFs)
    bs = bsdf_mod.sample_surface(mp, counter, n, u_bsdf, state.flags,
                                 present=scene.bsdfs_present)
    if scene.has_hair:
        # hair BSDF sample (automaton); compute-all-select against the
        # surface sample — skipped entirely for fur-less scenes (static gate)
        p_choice = (jnp.minimum((u_hairp * 3).astype(jnp.int32), 2)
                    if cfg.hair_p_random else jnp.zeros_like(state.flags))
        hs = fur.sample_hair(mp, counter, n, hit.fiber_u, hit.fiber_v,
                             hit.fiber_w, state.flags, p_choice)
        is_hair = mp.shader_id == SHADER_MARSCHNER_HAIR
        refl = jnp.where(is_hair[:, None], hs.reflectance, bs.reflectance)
        wo = jnp.where(is_hair[:, None], hs.wo, bs.wo)
        pdf = jnp.where(is_hair, hs.pdf, bs.pdf)
        new_flags = jnp.where(is_hair, hs.flags, bs.flags)
        hs_theta_i = hs.theta_i
    else:
        is_hair = jnp.zeros_like(state.flags, bool)
        refl, wo, pdf, new_flags = (bs.reflectance, bs.wo, bs.pdf, bs.flags)
        hs_theta_i = state.theta_i

    # common cutoff (SimpleShader.h:61-62 / MarschnerHairShader.h:78)
    refl_zero = jnp.all(refl == 0.0, axis=-1)
    if cfg.rr:  # unbiased RR replaces the biased throughput cutoff
        weak = jnp.zeros_like(refl_zero)
    else:
        weak = jnp.max(radiance, axis=-1) < 0.01
    kill = refl_zero | (pdf <= 1e-4) | weak

    emissive = (new_flags & MATFLAG_EMISSIVE_BOUNCE) != 0
    mid_walk = ((new_flags & (MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_CYLINDER_TR_BOUNCE)) != 0)

    # ray offset (SimpleShader.h:86-95)
    specular = (new_flags & MATFLAG_SPECULAR_BOUNCE) != 0
    off_spec = 1e-4 * wo
    off_diff = vm.faceforward(-1e-4 * n, n, wo)
    offset = jnp.where(specular[:, None], off_spec, off_diff)
    new_origin = hit.position + offset
    new_direction = wo

    # --- SimpleShader color/throughput update (SimpleShader.h:31-98)
    simple_color = accum + jnp.where((emissive & ~kill)[:, None], mp.emission * radiance, 0.0)
    simple_radiance = jnp.where(
        (kill | emissive)[:, None], 0.0,
        radiance * refl * (jnp.abs(vm.dot(wo, n)) / jnp.maximum(pdf, 1e-20))[:, None])

    # --- MarschnerHairShader update (MarschnerHairShader.h:31-84)
    hair_color = jnp.where(mid_walk[:, None], 0.0, accum)
    hair_radiance = jnp.where(
        mid_walk[:, None], radiance,
        jnp.where(kill[:, None], 0.0,
                  radiance * 3.0 * refl * jnp.abs(jnp.cos(hs_theta_i))[:, None]))

    geom3 = hit_geom[:, None]
    color = color + jnp.where(geom3, jnp.where(is_hair[:, None], hair_color, simple_color), 0.0)
    radiance = jnp.where(geom3, jnp.where(is_hair[:, None], hair_radiance, simple_radiance), radiance)
    radiance = jnp.minimum(radiance, cfg.clamp_throughput)

    if cfg.rr:
        u_rr = rng.bounce_uniform(keys, bounce, 1, tag=4)[:, 0]
        q = jnp.clip(jnp.max(radiance, axis=-1), 0.05, 1.0)
        do_rr = (bounce >= cfg.rr_start) & hit_geom & ~mid_walk
        dead = do_rr & (u_rr >= q)
        boost = jnp.where(do_rr & ~dead, 1.0 / q, 1.0)
        radiance = jnp.where(dead[:, None], 0.0, radiance * boost[:, None])

    # continuing rays get the new ray; hair updates its ray even mid-walk
    continuing = hit_geom & ~kill & ~emissive
    hair_moves = hit_geom & is_hair
    move = continuing | hair_moves
    origin = jnp.where(move[:, None], new_origin, state.origin)
    direction = jnp.where(move[:, None], new_direction, state.direction)
    # flags update: simple shader only when continuing (SimpleShader.h:84);
    # hair shader always (bsdf->sample writes them by reference)
    flags = jnp.where(hit_geom & is_hair, new_flags,
            jnp.where(continuing & ~is_hair, new_flags, state.flags))
    theta_i = jnp.where(hit_geom & is_hair, hs_theta_i, state.theta_i)

    if cfg.mis:
        spdf = bsdf_mod.sample_pdf(mp, n, counter, wo)
        spdf = jnp.where(is_hair, -1.0, spdf)
        prev_pdf = jnp.where(hit_geom, spdf, state.prev_pdf)
    else:
        prev_pdf = state.prev_pdf

    return RayState(origin=origin, direction=direction, radiance=radiance,
                    color=color, flags=flags, theta_i=theta_i,
                    prev_pdf=prev_pdf)


def trace_bounce_fused(state: RayState, scene: DeviceScene, keys, bounce,
                       cfg: RenderConfig, closest_fn=None, occlude_fn=None,
                       n_alive=None) -> RayState:
    """trace_bounce with the shade stage fused into one pass.

    Pipeline per bounce: closest-hit traversal -> material gather + env
    lookup + RNG draws -> fused shade stage (ops/pallas/shade.shade_bounce)
    -> shadow any-hit traversal -> one masked add of the NEE term. On
    level-2-eligible scenes the whole bounce is one kernel instead
    (pshade.use_full_kernel). Estimator-identical to trace_bounce
    (tests/test_fused_shade.py pins image agreement)."""
    from ..ops.pallas import shade as pshade
    from .shade_core import CoreCfg

    if pshade.use_full_kernel(
            jax.default_backend(), scene,
            overridden=closest_fn is not None or occlude_fn is not None,
            force_interpret=cfg.interpret):
        u_bsdf = rng.bounce_uniform(keys, bounce, 2, tag=0)
        u_pick = rng.bounce_uniform(keys, bounce, 1, tag=1)[:, 0]
        u_light = rng.bounce_uniform(keys, bounce, 2, tag=2)
        u_hairp = rng.bounce_uniform(keys, bounce, 1, tag=3)[:, 0]
        u_rr = (rng.bounce_uniform(keys, bounce, 1, tag=4)[:, 0]
                if cfg.rr else jnp.zeros_like(u_pick))
        r = state.origin.shape[0]
        rr_gate = jnp.broadcast_to(
            jnp.where(bounce >= cfg.rr_start, 1.0, 0.0), (r,))
        ccfg = CoreCfg(n_lights=scene.lights.count, mis=cfg.mis, rr=cfg.rr,
                       has_hair=scene.has_hair,
                       hair_p_random=cfg.hair_p_random,
                       clamp_throughput=cfg.clamp_throughput,
                       bsdfs_present=scene.bsdfs_present)
        out = pshade.shade_bounce_full(
            origin=state.origin, direction=state.direction,
            radiance=state.radiance, color=state.color, flags=state.flags,
            theta_i=state.theta_i, prev_pdf=state.prev_pdf,
            mats_table=pshade.pack_mats_table(scene.materials),
            tris_table=pshade.pack_tris_table(scene.tris),
            lights_table=pshade.pack_lights_table(scene.lights),
            env_color3=scene.env.color, env_ambient=scene.env.ambient,
            n_lights=scene.lights.count, n_tris=scene.tris.count,
            u_bsdf=u_bsdf, u_pick=u_pick, u_light=u_light, u_hairp=u_hairp,
            u_rr=u_rr, rr_gate=rr_gate, cfg=ccfg, interpret=cfg.interpret)
        return RayState(origin=out["origin"], direction=out["direction"],
                        radiance=out["radiance"], color=out["color"],
                        flags=out["flags"], theta_i=out["theta_i"],
                        prev_pdf=out["prev_pdf"])

    active = jnp.any(state.radiance != 0.0, axis=-1)
    has_dir = jnp.any(state.direction != 0.0, axis=-1)
    do_trace = active & has_dir
    t_cap = jnp.where(do_trace, isect.INF, 0.0)

    if closest_fn is None:
        hit = traverse.closest_hit(state.origin, state.direction, scene,
                                   t_max=t_cap, chunk=cfg.ray_chunk,
                                   n_alive=n_alive)
    else:
        hit = closest_fn(state.origin, state.direction, scene)

    out = _fused_shade_stage(state, scene, keys, bounce, cfg, hit)

    t_max = out["shadow_tmax"]
    if scene.lights.count:
        if occlude_fn is None:
            blocked = traverse.any_hit(out["shadow_o"], out["shadow_d"],
                                       scene, t_max, chunk=cfg.ray_chunk,
                                       n_alive=n_alive)
        else:
            blocked = occlude_fn(out["shadow_o"], out["shadow_d"], scene,
                                 t_max)
        color = out["color"] + jnp.where(blocked[:, None], 0.0,
                                         out["direct_rgb"])
    else:
        color = out["color"]

    return RayState(origin=out["origin"], direction=out["direction"],
                    radiance=out["radiance"], color=color,
                    flags=out["flags"], theta_i=out["theta_i"],
                    prev_pdf=out["prev_pdf"])


def _fused_shade_stage(state: RayState, scene, keys, bounce,
                       cfg: RenderConfig, hit) -> dict:
    """Material gather + env lookup + RNG draws + the fused shade stage.
    Returns shade_bounce's output row dict."""
    from ..ops.pallas import shade as pshade
    from .shade_core import CoreCfg

    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv,
                                   scene.textures, scene.tex_slots)
    env_c = shading.environment_color(scene.env, state.direction)

    u_bsdf = rng.bounce_uniform(keys, bounce, 2, tag=0)
    u_pick = rng.bounce_uniform(keys, bounce, 1, tag=1)[:, 0]
    u_light = rng.bounce_uniform(keys, bounce, 2, tag=2)
    u_hairp = rng.bounce_uniform(keys, bounce, 1, tag=3)[:, 0]
    if cfg.rr:
        u_rr = rng.bounce_uniform(keys, bounce, 1, tag=4)[:, 0]
    else:
        u_rr = jnp.zeros_like(u_pick)
    r = state.origin.shape[0]
    rr_gate = jnp.broadcast_to(
        jnp.where(bounce >= cfg.rr_start, 1.0, 0.0), (r,))

    ccfg = CoreCfg(n_lights=scene.lights.count, mis=cfg.mis, rr=cfg.rr,
                   has_hair=scene.has_hair,
                   hair_p_random=cfg.hair_p_random,
                   clamp_throughput=cfg.clamp_throughput,
                   bsdfs_present=scene.bsdfs_present)
    mp_fields = dict(diffuse=mp.diffuse, specular=mp.specular,
                     volume=mp.volume, emission=mp.emission, ior=mp.ior,
                     transparency=mp.transparency,
                     reflectivity=mp.reflectivity, roughness=mp.roughness,
                     bsdf_id=mp.bsdf_id, shader_id=mp.shader_id,
                     hair_alpha=mp.hair_alpha, hair_beta=mp.hair_beta)
    return pshade.shade_bounce(
        origin=state.origin, direction=state.direction,
        radiance=state.radiance, color=state.color, flags=state.flags,
        theta_i=state.theta_i, prev_pdf=state.prev_pdf, hit_t=hit.t,
        hit_valid=hit.valid, hit_pos=hit.position, hit_normal=hit.normal,
        fib_u=hit.fiber_u, fib_v=hit.fiber_v, fib_w=hit.fiber_w,
        mp_fields=mp_fields, env_color=env_c,
        env_ambient=scene.env.ambient,
        lights_table=pshade.pack_lights_table(scene.lights),
        n_lights=scene.lights.count, u_bsdf=u_bsdf, u_pick=u_pick,
        u_light=u_light, u_hairp=u_hairp, u_rr=u_rr, rr_gate=rr_gate,
        cfg=ccfg)


def render_sample_ids(scene: DeviceScene, camera: cam_mod.Camera, pixel_ids, key,
                      sample_idx, cfg: RenderConfig, closest_fn=None,
                      occlude_fn=None) -> jnp.ndarray:
    """One progressive sample for an arbitrary set of *global* pixel ids ->
    color [len(ids),3]. This is the shardable unit: RNG keys depend on the
    global id, so any partition of the image across devices renders
    bit-identically to the single-device pass."""
    from ..scene.types import ensure_device
    scene = ensure_device(scene)
    w, _ = camera.resolution
    px = (pixel_ids % w).astype(jnp.float32)
    py = (pixel_ids // w).astype(jnp.float32)
    keys = rng.keys_for_pixels(key, pixel_ids, sample_idx)
    if cfg.qmc:
        jitter = rng.qmc_jitter(key, pixel_ids, sample_idx, cfg.spp)
    else:
        jitter = rng.bounce_uniform(keys, -1, 2, tag=7)
    dof_u = rng.bounce_uniform(keys, -1, 2, tag=8) if camera.use_dof else None
    o, d = cam_mod.rays_from_pixels(camera, px, py, jitter, dof_u)
    state = init_state(o, d)

    subpaths = None
    if cfg.bdpt and scene.lights.count:
        from . import bdpt as bdpt_mod
        sub_key = jax.random.fold_in(jax.random.fold_in(key, sample_idx), 0x1bb)
        subpaths = bdpt_mod.build_light_subpaths(
            scene, sub_key, cfg.bdpt_samples_per_light, cfg.bdpt_bounces,
            ray_chunk=cfg.ray_chunk, occlude_fn=occlude_fn,
            closest_fn=closest_fn)

    # fused shade stage (cfg.fused_shading): bdpt keeps the unfused path
    # (its eye-vertex connection replaces NEE inside trace_bounce)
    use_fused = cfg.fused_shading and not cfg.bdpt

    def step(st, ks, b, n_alive=None):
        if use_fused:
            return trace_bounce_fused(st, scene, ks, b, cfg, closest_fn,
                                      occlude_fn, n_alive=n_alive)
        return trace_bounce(st, scene, ks, b, cfg, closest_fn, occlude_fn,
                            subpaths, n_alive=n_alive)

    bounce_fn = step
    if cfg.remat:
        bounce_fn = jax.checkpoint(
            lambda st, ks, b, n_alive=None: step(st, ks, b, n_alive),
            static_argnums=())

    if cfg.compact:
        from ..ops import compact as compact_mod

        def body(b, carry):
            st, ks, slot, n_alive = carry
            st = bounce_fn(st, ks, b, n_alive=n_alive)
            alive = jnp.any(st.radiance != 0.0, axis=-1)
            perm, n_alive = compact_mod.compaction_permutation(alive)
            st = compact_mod.gather_pytree(st, perm)
            return st, ks[perm], slot[perm], n_alive

        r = state.origin.shape[0]
        carry = (state, keys, jnp.arange(r, dtype=jnp.int32), jnp.int32(r))
        state, _, slot, _ = jax.lax.fori_loop(0, cfg.depth, body, carry)
        color = jnp.zeros_like(state.color).at[slot].set(state.color)
    else:
        def body(b, st):
            return bounce_fn(st, keys, b)

        state = jax.lax.fori_loop(0, cfg.depth, body, state)
        color = state.color
    if subpaths is not None and cfg.bdpt_splat:
        from . import bdpt as bdpt_mod
        color = color + bdpt_mod.splat_image_plane(
            scene, camera, subpaths, pixel_ids, keys,
            ray_chunk=cfg.ray_chunk, occlude_fn=occlude_fn)
    return color


def render_sample(scene: DeviceScene, camera: cam_mod.Camera, key, sample_idx,
                  cfg: RenderConfig) -> jnp.ndarray:
    """One full progressive sample -> per-pixel color [R,3]
    (PathTracer::processSegment, CPU_PathTracer.cpp:54-59)."""
    w, h = camera.resolution
    pixel_ids = jnp.arange(w * h)
    return render_sample_ids(scene, camera, pixel_ids, key, sample_idx, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def render_image(scene: DeviceScene, camera: cam_mod.Camera, key,
                 cfg: RenderConfig) -> jnp.ndarray:
    """Full render: running-mean accumulate `cfg.spp` samples -> [H,W,3]."""

    w, h = camera.resolution
    r = w * h
    bsz = cfg.spp_batch if cfg.spp_batch > 1 and cfg.spp % cfg.spp_batch == 0 else 1

    if bsz == 1:
        def body(i, acc):
            c = render_sample(scene, camera, key, i, cfg)
            return acc + (c - acc) / (i + 1.0)
    else:
        def body(i, acc):
            cs = jax.vmap(
                lambda s: render_sample(scene, camera, key, s, cfg)
            )(i * bsz + jnp.arange(bsz))
            return acc + (cs.mean(0) - acc) / (i + 1.0)

    trips = cfg.spp // bsz
    init = jnp.zeros((r, 3), jnp.float32)
    # trip-count-1 elision: a 1-trip fori_loop still pays the full scan-AD
    # machinery under grad (measured: the spp wrapper alone added ~40% to
    # the sharded train-step XLA compile) — call the body directly instead
    acc = body(0, init) if trips == 1 else jax.lax.fori_loop(0, trips, body, init)
    img = acc.reshape(h, w, 3)
    if cfg.tonemap:
        from ..ops import tonemap
        img = tonemap.tonemap(img)
    return img


def render_progressive(scene, camera, key, cfg: RenderConfig, accum=None, start_sample=0):
    """Host-side progressive loop yielding (sample_index, image) — the
    interactive `render()`-per-frame analog (CPU_PathTracer.cpp:17-52) and
    the checkpoint/resume surface (SURVEY §5)."""
    w, h = camera.resolution
    r = w * h
    acc = jnp.zeros((r, 3), jnp.float32) if accum is None else accum.reshape(r, 3)
    sample_jit = jax.jit(render_sample, static_argnames=("cfg",))
    for i in range(start_sample, cfg.spp):
        c = sample_jit(scene, camera, key, i, cfg)
        acc = acc + (c - acc) / (i + 1.0)
        yield i, acc.reshape(h, w, 3)
