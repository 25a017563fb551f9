"""Fused per-bounce shading: the XLA shade stage and the level-2 kernel.

`shade_bounce` runs models/shade_core.shade_bounce_core — the ENTIRE
post-traversal bounce stage (analytic light hits, env/light termination,
NEE sampling, the 9-BSDF cascade, the Marschner/d'Eon hair automaton,
throughput/flag updates) — over [R]-row arrays under plain XLA, which fuses
the elementwise chain by itself.

`shade_bounce_full` is the level-2 kernel for small untextured triangle
scenes (the NoDataStructure path — the Cornell configs): the Möller–Trumbore
closest hit over the scene's triangle table, barycentric normal
interpolation, the material lookup, the whole shade stage AND the NEE
shadow any-hit run in ONE Pallas program per block of rays, compiled
through Triton. The ray state stays in registers for the whole bounce;
per bounce the only XLA ops left are the RNG draws and the state
pack/unpack. This is the pt_trace.compute + pt_shade.compute pair of the
reference's GPU pipeline (pt_shade.compute:99-287) fused.

Kernel layout: one program per BLOCK rays (1-D grid). Per-ray channels are
packed component-major as [C, R] so every channel is one contiguous [BLOCK]
vector. The triangle, material and light tables are read as scalars (or,
for the winner's row, as a per-ray gather) straight from global memory,
where L1 serves them; the triangle loops are lax.fori_loops, so compile
time does not grow with the triangle count. Triton wants power-of-two
shapes, so channel stacks and tables are zero-padded to powers of two.

`interpret=True` runs the same kernel in the Pallas interpreter (how the
CPU tests check it); no code path picks it from the platform.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ...models import shade_core as sc
from ...models.shade_core import CoreCfg, CoreLight, CoreMat, V3

#: rays per program and warps per program of the level-2 kernel (one ray
#: per thread at 128 / 4)
BLOCK = 128
NUM_WARPS = 4
#: columns of the light table:
#: kind(1) color(3) pos(3) dir(3) radius(1) const/lin/quad(3) verts(12)
#: inner(1) outer(1) area(1) = 29
_LIGHT_FIELDS = 29


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_pow2(table, min_rows: int = 1) -> jnp.ndarray:
    """Zero-pad a 2-D table to power-of-two rows and columns (Triton's
    shape rule); at least `min_rows` rows, so an empty table stays
    addressable."""
    r, c = table.shape
    rp, cp = _pow2(max(r, min_rows)), _pow2(c)
    return jnp.pad(jnp.asarray(table, jnp.float32), ((0, rp - r), (0, cp - c)))


def pack_lights_table(lights) -> jnp.ndarray:
    """LightPack -> [L, 29] f32 scalar table (+ area precomputed for MIS)."""
    v = jnp.asarray(lights.verts, jnp.float32)  # [L,4,3]
    a1 = 0.5 * jnp.linalg.norm(
        jnp.cross(v[:, 1] - v[:, 0], v[:, 3] - v[:, 0]), axis=-1)
    a2 = 0.5 * jnp.linalg.norm(
        jnp.cross(v[:, 1] - v[:, 2], v[:, 3] - v[:, 2]), axis=-1)
    area = jnp.maximum(a1 + a2, 1e-12)
    cols = [jnp.asarray(lights.kind, jnp.float32)[:, None],
            jnp.asarray(lights.color, jnp.float32),
            jnp.asarray(lights.position, jnp.float32),
            jnp.asarray(lights.direction, jnp.float32),
            jnp.asarray(lights.radius, jnp.float32)[:, None],
            jnp.asarray(lights.const_att, jnp.float32)[:, None],
            jnp.asarray(lights.lin_att, jnp.float32)[:, None],
            jnp.asarray(lights.quad_att, jnp.float32)[:, None],
            v.reshape(v.shape[0], 12),
            jnp.asarray(lights.inner_angle, jnp.float32)[:, None],
            jnp.asarray(lights.outer_angle, jnp.float32)[:, None],
            area[:, None]]
    return jnp.concatenate(cols, axis=1)


def core_light(table, l) -> CoreLight:
    """CoreLight of 0-d scalars from row `l` of the 29-column table."""
    o = {"kind": 0, "color": 1, "position": 4, "direction": 7, "radius": 10,
         "const_att": 11, "lin_att": 12, "quad_att": 13, "verts": 14,
         "inner": 26, "outer": 27, "area": 28}

    def g(c):
        return table[l, c]
    def vec(c):
        return V3(g(c), g(c + 1), g(c + 2))
    return CoreLight(
        kind=g(o["kind"]).astype(jnp.int32), color=vec(o["color"]),
        position=vec(o["position"]), direction=vec(o["direction"]),
        radius=g(o["radius"]), const_att=g(o["const_att"]),
        lin_att=g(o["lin_att"]), quad_att=g(o["quad_att"]),
        v0=vec(o["verts"]), v1=vec(o["verts"] + 3), v2=vec(o["verts"] + 6),
        v3=vec(o["verts"] + 9), inner_angle=g(o["inner"]),
        outer_angle=g(o["outer"]), area=g(o["area"]))


def shade_bounce(*, origin, direction, radiance, color, flags, theta_i,
                 prev_pdf, hit_t, hit_valid, hit_pos, hit_normal,
                 fib_u, fib_v, fib_w, mp_fields: dict, env_color,
                 env_ambient, lights_table, n_lights: int,
                 u_bsdf, u_pick, u_light, u_hairp, u_rr, rr_gate,
                 cfg: CoreCfg):
    """Run the fused bounce shade under XLA. All array args are [R]-row /
    [R,3] wavefront arrays; returns the CoreOut fields in that convention."""
    def V(a):
        return V3(a[:, 0], a[:, 1], a[:, 2])
    lights = [core_light(lights_table, l) for l in range(n_lights)]
    mp = CoreMat(
        diffuse=V(mp_fields["diffuse"]), specular=V(mp_fields["specular"]),
        volume=V(mp_fields["volume"]), emission=V(mp_fields["emission"]),
        ior=mp_fields["ior"], transparency=mp_fields["transparency"],
        reflectivity=mp_fields["reflectivity"],
        roughness=mp_fields["roughness"], bsdf_id=mp_fields["bsdf_id"],
        shader_id=mp_fields["shader_id"],
        hair_alpha=mp_fields["hair_alpha"],
        hair_beta=mp_fields["hair_beta"])
    out = sc.shade_bounce_core(
        origin=V(origin), direction=V(direction), radiance=V(radiance),
        color=V(color), flags=flags, theta_i=theta_i, prev_pdf=prev_pdf,
        hit_t=hit_t, hit_valid=hit_valid, hit_pos=V(hit_pos),
        hit_normal=V(hit_normal), fib_u=V(fib_u), fib_v=V(fib_v),
        fib_w=V(fib_w), mp=mp, env_color=V(env_color),
        env_ambient=V3(env_ambient[0], env_ambient[1], env_ambient[2]),
        lights=lights, u_bsdf1=u_bsdf[:, 0], u_bsdf2=u_bsdf[:, 1],
        u_pick=u_pick, u_light1=u_light[:, 0], u_light2=u_light[:, 1],
        u_hairp=u_hairp, u_rr=u_rr, rr_gate=rr_gate, cfg=cfg)

    def m(v):
        return jnp.stack([v.x, v.y, v.z], axis=-1)
    return dict(origin=m(out.origin), direction=m(out.direction),
                radiance=m(out.radiance), color=m(out.color),
                flags=out.flags, theta_i=out.theta_i,
                prev_pdf=out.prev_pdf, shadow_o=m(out.shadow_o),
                shadow_d=m(out.shadow_d), shadow_tmax=out.shadow_tmax,
                direct_rgb=m(out.direct_rgb))


# ---------------------------------------------------------------------------
# Level-2 full-bounce kernel: brute-force scenes (Cornell class)
# ---------------------------------------------------------------------------

MAX_FULL_FUSE_TRIS = 512  # triangle-table cap of the level-2 path
_T_MIN = 1e-4  # bruteforce.closest_hit/any_hit default t_min


def pack_tris_table(tris) -> jnp.ndarray:
    """TrianglePack -> [T, 19] f32 (v0, e1, e2, n0, n1, n2, mat_id)."""
    v0 = jnp.asarray(tris.v0, jnp.float32)
    e1 = jnp.asarray(tris.v1, jnp.float32) - v0
    e2 = jnp.asarray(tris.v2, jnp.float32) - v0
    return jnp.concatenate([
        v0, e1, e2, jnp.asarray(tris.n0, jnp.float32),
        jnp.asarray(tris.n1, jnp.float32), jnp.asarray(tris.n2, jnp.float32),
        jnp.asarray(tris.mat_id, jnp.float32)[:, None]], axis=1)


def pack_mats_table(materials) -> jnp.ndarray:
    """MaterialTable -> [M, 20] f32 (diffuse3 specular3 volume3 emission3
    ior transparency reflectivity roughness bsdf_id shader_id alpha beta)."""
    m = materials
    f = lambda x: jnp.asarray(x, jnp.float32)
    return jnp.concatenate([
        f(m.diffuse), f(m.specular), f(m.volume), f(m.emission),
        f(m.ior)[:, None], f(m.transparency)[:, None],
        f(m.reflectivity)[:, None], f(m.roughness)[:, None],
        f(m.bsdf_id)[:, None], f(m.shader_id)[:, None],
        f(m.hair_alpha)[:, None], f(m.hair_beta)[:, None]], axis=1)


def full_fuse_eligible(scene) -> bool:
    """Static scene test for the level-2 path."""
    from ...scene.types import ENV_COLOR
    return (scene.tri_bvh is None and scene.cone_bvh is None
            and int(scene.cones.count) == 0
            and 0 < int(scene.tris.count) <= MAX_FULL_FUSE_TRIS
            and scene.textures is None
            and (scene.env.kind == ENV_COLOR or scene.env.texture is None)
            and not scene.has_hair)


def use_full_kernel(platform: str, scene, *, overridden: bool = False,
                    force_interpret: bool = False) -> bool:
    """Kernel-choice policy of the fused bounce: the level-2 kernel runs
    compiled on the GPU (or in the interpreter when a caller asks for it
    explicitly) for level-2-eligible scenes whose traversal the caller has
    not overridden; every other case takes the XLA shade stage."""
    if overridden or not full_fuse_eligible(scene):
        return False
    return force_interpret or platform == "gpu"


def _tri_t(o, d, v0, e1, e2, t_min, t_max):
    """Candidate t for ONE triangle given scalar corners (exact
    isect.triangle_hit_grid arithmetic). Returns (t, valid, u, v)."""
    px = d.y * e2[2] - d.z * e2[1]
    py = d.z * e2[0] - d.x * e2[2]
    pz = d.x * e2[1] - d.y * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    near_zero = jnp.abs(det) < 1.1920929e-7
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    tx, ty, tz = o.x - v0[0], o.y - v0[1], o.z - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    valid = ((~near_zero) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, valid, u, v


#: per-ray input channels of the level-2 kernel, in [C, R] row order
_IN_ROWS = 22  # origin3 dir3 radiance3 color3 theta prev_pdf + 8 uniforms
_OUT_ROWS = 14  # origin3 dir3 radiance3 color3 theta prev_pdf


def shade_bounce_full(*, origin, direction, radiance, color, flags, theta_i,
                      prev_pdf, mats_table, tris_table, lights_table,
                      env_color3, env_ambient, n_lights: int, n_tris: int,
                      u_bsdf, u_pick, u_light, u_hairp, u_rr, rr_gate,
                      cfg: CoreCfg, interpret: bool = False,
                      block: int = BLOCK, num_warps: int = NUM_WARPS):
    """Level-2 fused bounce for brute-force triangle scenes. Wavefront
    [R]-row I/O like shade_bounce, but no traversal/hit inputs — the
    kernel intersects the triangle table itself and applies the NEE
    shadow occlusion in-program. Returns the new RayState fields."""
    r = origin.shape[0]

    def cols(v):
        return [v[:, 0], v[:, 1], v[:, 2]]

    f_rows = (cols(origin) + cols(direction) + cols(radiance) + cols(color)
              + [theta_i, prev_pdf]
              + [u_bsdf[:, 0], u_bsdf[:, 1], u_pick, u_light[:, 0],
                 u_light[:, 1], u_hairp, u_rr, rr_gate])
    assert len(f_rows) == _IN_ROWS
    cf, co = _pow2(_IN_ROWS), _pow2(_OUT_ROWS)
    r_pad = r + (-r) % block
    fin = jnp.stack([jnp.asarray(x, jnp.float32) for x in f_rows])
    fin = jnp.pad(fin, ((0, cf - _IN_ROWS), (0, r_pad - r)))
    iin = jnp.pad(jnp.asarray(flags, jnp.int32)[None], ((0, 0), (0, r_pad - r)))
    params = jnp.pad(jnp.concatenate([
        jnp.asarray(env_ambient, jnp.float32).reshape(3),
        jnp.asarray(env_color3, jnp.float32).reshape(3)]), (0, 2))
    if n_lights == 0:
        lights_table = jnp.zeros((1, _LIGHT_FIELDS), jnp.float32)
    ltab = pad_pow2(lights_table)
    ttab = pad_pow2(tris_table)
    mtab = pad_pow2(mats_table)

    kernel = functools.partial(_full_bounce_kernel, n_lights=n_lights,
                               n_tris=n_tris, cfg=cfg)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    rows = lambda c: pl.BlockSpec((c, block), lambda i: (0, i))
    fout, iout = pl.pallas_call(
        kernel,
        grid=(r_pad // block,),
        in_specs=[whole(params), whole(ltab), whole(ttab), whole(mtab),
                  rows(cf), rows(1)],
        out_specs=[rows(co), rows(1)],
        out_shape=[jax.ShapeDtypeStruct((co, r_pad), jnp.float32),
                   jax.ShapeDtypeStruct((1, r_pad), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="full_bounce",
    )(params, ltab, ttab, mtab, fin, iin)

    fo = fout[:, :r]

    def vec(i):
        return jnp.stack([fo[i], fo[i + 1], fo[i + 2]], axis=-1)

    return dict(origin=vec(0), direction=vec(3), radiance=vec(6),
                color=vec(9), theta_i=fo[12], prev_pdf=fo[13],
                flags=iout[0, :r])


def _full_bounce_kernel(params_ref, lights_ref, tris_ref, mats_ref,
                        fin_ref, iin_ref, fout_ref, iout_ref, *,
                        n_lights: int, n_tris: int, cfg: CoreCfg):
    def row(c):
        return fin_ref[c, :]

    def vec(c):
        return V3(row(c), row(c + 1), row(c + 2))

    origin, direction, radiance, color = vec(0), vec(3), vec(6), vec(9)
    theta_i, prev_pdf = row(12), row(13)
    u_bsdf1, u_bsdf2, u_pick = row(14), row(15), row(16)
    u_light1, u_light2 = row(17), row(18)
    u_hairp, u_rr, rr_gate = row(19), row(20), row(21)
    flags = iin_ref[0, :]
    shape = origin.x.shape

    env_ambient = V3(params_ref[0], params_ref[1], params_ref[2])
    env_color = V3(jnp.full(shape, params_ref[3]),
                   jnp.full(shape, params_ref[4]),
                   jnp.full(shape, params_ref[5]))
    lights = [core_light(lights_ref, l) for l in range(n_lights)]

    def tri_geom(j):
        g = lambda c: tris_ref[j, c]
        return ((g(0), g(1), g(2)), (g(3), g(4), g(5)), (g(6), g(7), g(8)))

    # --- in-program closest hit (bruteforce._closest_chunk semantics:
    # the first triangle with the smallest t wins)
    active = (radiance.x != 0.0) | (radiance.y != 0.0) | (radiance.z != 0.0)
    has_dir = (direction.x != 0.0) | (direction.y != 0.0) \
        | (direction.z != 0.0)
    t_cap = jnp.where(active & has_dir, sc.INF, 0.0)

    def closest(j, carry):
        t_best, j_best, u_b, v_b = carry
        t, valid, u, v = _tri_t(origin, direction, *tri_geom(j), _T_MIN,
                                t_cap)
        better = valid & (t < t_best)
        return (jnp.where(better, t, t_best), jnp.where(better, j, j_best),
                jnp.where(better, u, u_b), jnp.where(better, v, v_b))

    zero = jnp.zeros(shape, jnp.float32)
    t_best, j_best, u_b, v_b = jax.lax.fori_loop(
        0, n_tris, closest,
        (jnp.full(shape, sc.INF, jnp.float32), jnp.full(shape, -1, jnp.int32),
         zero, zero))

    hit_valid = j_best >= 0
    hit_t = jnp.where(hit_valid, t_best, sc.INF)
    hit_pos = origin + direction * jnp.where(hit_valid, t_best, 0.0)
    # the winner's row, gathered per ray (row 0 on a miss: masked below)
    jw = jnp.maximum(j_best, 0)

    def tcol(c):
        return tris_ref[jw, c]

    def tvec(c):
        return V3(tcol(c), tcol(c + 1), tcol(c + 2))

    w_b = 1.0 - u_b - v_b
    hit_normal = sc.normalize3(tvec(9) * w_b + tvec(12) * u_b
                               + tvec(15) * v_b)
    mat_id = tcol(18).astype(jnp.int32)

    def mcol(c):
        return mats_ref[mat_id, c]

    def mvec(c):
        return V3(mcol(c), mcol(c + 1), mcol(c + 2))

    mp = CoreMat(diffuse=mvec(0), specular=mvec(3), volume=mvec(6),
                 emission=mvec(9), ior=mcol(12), transparency=mcol(13),
                 reflectivity=mcol(14), roughness=mcol(15),
                 bsdf_id=mcol(16).astype(jnp.int32),
                 shader_id=mcol(17).astype(jnp.int32),
                 hair_alpha=mcol(18), hair_beta=mcol(19))

    one = jnp.ones(shape, jnp.float32)
    out = sc.shade_bounce_core(
        origin=origin, direction=direction, radiance=radiance, color=color,
        flags=flags, theta_i=theta_i, prev_pdf=prev_pdf, hit_t=hit_t,
        hit_valid=hit_valid, hit_pos=hit_pos, hit_normal=hit_normal,
        fib_u=V3(one, zero, zero), fib_v=V3(zero, one, zero),
        fib_w=V3(zero, zero, one), mp=mp, env_color=env_color,
        env_ambient=env_ambient, lights=lights, u_bsdf1=u_bsdf1,
        u_bsdf2=u_bsdf2, u_pick=u_pick, u_light1=u_light1,
        u_light2=u_light2, u_hairp=u_hairp, u_rr=u_rr, rr_gate=rr_gate,
        cfg=cfg)

    # --- in-program shadow any-hit (bruteforce._any_chunk semantics)
    so, sd, stmax = out.shadow_o, out.shadow_d, out.shadow_tmax

    def shadow(j, blocked):
        _, valid, _, _ = _tri_t(so, sd, *tri_geom(j), _T_MIN, stmax)
        return blocked | valid.astype(jnp.int32)

    blocked = jax.lax.fori_loop(0, n_tris, shadow,
                                jnp.zeros(shape, jnp.int32)) != 0
    final_color = out.color + sc.where3(blocked, 0.0, out.direct_rgb)

    for i, v in enumerate((out.origin, out.direction, out.radiance,
                           final_color)):
        fout_ref[3 * i, :] = v.x
        fout_ref[3 * i + 1, :] = v.y
        fout_ref[3 * i + 2, :] = v.z
    fout_ref[12, :] = out.theta_i
    fout_ref[13, :] = out.prev_pdf
    iout_ref[0, :] = out.flags
