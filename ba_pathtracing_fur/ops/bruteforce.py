"""Brute-force O(N) scene intersection — the `NoDataStructure` analog.

Parity target: KIRK::CPU::NoDataStructure (CPU_NoDataStructure.h:9-24) which
the reference uses as the accel-structure oracle (SURVEY §4.3). The
all-pairs ray×primitive grid is dense vector compute, so for small scenes
this *is* the fast path; for large scenes it is the correctness oracle for
the LBVH (ops/bvh.py) and the level-2 bounce kernel (ops/pallas/shade.py).

Rays are processed in static chunks so the [chunk, N_prims] grids stay
within the device-memory budget — the equivalent of the reference's
BufferSegmentation memory capping (BufferSegmentation.h:34-77).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import pytree, vecmath as vm
from ..scene.types import ConePack, DeviceScene, TrianglePack
from . import intersect as isect

INF = isect.INF

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_CONE = 1


@pytree.dataclass
class Hit:
    """SoA hit record — the wavefront analog of KIRK::Intersection
    (Intersection.h:11-48)."""

    t: jnp.ndarray  # [R]
    valid: jnp.ndarray  # [R] bool (scene geometry hit)
    prim_type: jnp.ndarray  # [R] int32: -1 none, 0 triangle, 1 cone
    prim_id: jnp.ndarray  # [R] int32
    mat_id: jnp.ndarray  # [R] int32
    position: jnp.ndarray  # [R,3]
    normal: jnp.ndarray  # [R,3]
    uv: jnp.ndarray  # [R,2]
    enter: jnp.ndarray  # [R] bool (cone enter flag)
    # fiber frame at the hit (cones: their own frame; triangles: stamped
    # fiber frame for fur-as-triangles mode, Object.h:33-38)
    fiber_u: jnp.ndarray  # [R,3]
    fiber_v: jnp.ndarray
    fiber_w: jnp.ndarray


def _nearest_over_grid(t_grid):
    """argmin over prim axis -> (t_best [R], id [R])."""
    idx = jnp.argmin(t_grid, axis=-1)
    t = jnp.take_along_axis(t_grid, idx[:, None], axis=-1)[:, 0]
    return t, idx.astype(jnp.int32)


def _closest_chunk(o, d, scene: DeviceScene, t_min, t_max):
    tris, cones = scene.tris, scene.cones
    r = o.shape[0]
    # per-ray t_max support (dead-lane capping): grids compare [R, P] < cap
    t_max = jnp.asarray(t_max, jnp.float32)
    cap = t_max[:, None] if t_max.ndim == 1 else t_max

    t_tri = jnp.full((r,), INF)
    tri_id = jnp.zeros((r,), jnp.int32)
    if tris.count:
        tg, _, _, _ = isect.triangle_hit_grid(o, d, tris, t_min, cap)
        t_tri, tri_id = _nearest_over_grid(tg)

    t_cone = jnp.full((r,), INF)
    cone_id = jnp.zeros((r,), jnp.int32)
    enter_all = jnp.zeros((r,), bool)
    if cones.count:
        cg, enter_g, _ = isect.cone_hit_grid(o, d, cones, t_min, cap)
        t_cone, cone_id = _nearest_over_grid(cg)
        enter_all = jnp.take_along_axis(enter_g, cone_id[:, None], axis=-1)[:, 0]

    cone_wins = t_cone < t_tri
    t = jnp.where(cone_wins, t_cone, t_tri)
    valid = t < t_max
    prim_type = jnp.where(~valid, PRIM_NONE, jnp.where(cone_wins, PRIM_CONE, PRIM_TRI)).astype(jnp.int32)
    prim_id = jnp.where(cone_wins, cone_id, tri_id)
    position = o + t[:, None] * d

    # normals / uvs / material for the winner only
    n = jnp.zeros_like(o)
    uv = jnp.zeros((r, 2), jnp.float32)
    mat_id = jnp.zeros((r,), jnp.int32)
    fu = jnp.zeros_like(o)
    fv = jnp.zeros_like(o)
    fw = jnp.zeros_like(o)
    if tris.count:
        tn, tuv, _ = isect.triangle_interpolate(tris, tri_id, position, o, d)
        is_tri = prim_type == PRIM_TRI
        n = jnp.where(is_tri[:, None], tn, n)
        uv = jnp.where(is_tri[:, None], tuv, uv)
        mat_id = jnp.where(is_tri, tris.mat_id[tri_id], mat_id)
        fu = jnp.where(is_tri[:, None], tris.fiber_u[tri_id], fu)
        fv = jnp.where(is_tri[:, None], tris.fiber_v[tri_id], fv)
        fw = jnp.where(is_tri[:, None], tris.fiber_w[tri_id], fw)
    if cones.count:
        cn = isect.cone_normal(cones, cone_id, position)
        cuv = isect.cone_texcoord(cones, cone_id, position)
        is_cone = prim_type == PRIM_CONE
        n = jnp.where(is_cone[:, None], cn, n)
        uv = jnp.where(is_cone[:, None], cuv, uv)
        mat_id = jnp.where(is_cone, cones.mat_id[cone_id], mat_id)
        fu = jnp.where(is_cone[:, None], cones.u[cone_id], fu)
        fv = jnp.where(is_cone[:, None], cones.v[cone_id], fv)
        fw = jnp.where(is_cone[:, None], cones.w[cone_id], fw)

    return Hit(
        t=jnp.where(valid, t, INF), valid=valid, prim_type=prim_type,
        prim_id=prim_id, mat_id=mat_id, position=position, normal=n, uv=uv,
        enter=enter_all & (prim_type == PRIM_CONE), fiber_u=fu, fiber_v=fv,
        fiber_w=fw,
    )


def _empty_hit(r: int) -> Hit:
    z3 = jnp.zeros((r, 3), jnp.float32)
    return Hit(t=jnp.full((r,), INF), valid=jnp.zeros((r,), bool),
               prim_type=jnp.full((r,), PRIM_NONE, jnp.int32),
               prim_id=jnp.zeros((r,), jnp.int32),
               mat_id=jnp.zeros((r,), jnp.int32), position=z3, normal=z3,
               uv=jnp.zeros((r, 2), jnp.float32),
               enter=jnp.zeros((r,), bool), fiber_u=z3, fiber_v=z3,
               fiber_w=z3)


def _chunked(fn, o, d, t_max, chunk: int, n_alive=None, empty=None):
    """fn(o, d, t_max) -> pytree of [rows, ...], applied over static chunks
    of `chunk` rays (lax.map bounds the live [chunk, P] grids) and
    concatenated back to R rows. With a compacted wavefront (live rays
    first — ops.compact), chunks wholly past the traced `n_alive` return
    `empty(chunk)` via lax.cond instead — the pt_sortHits payoff
    (pt_sortHits.compute:17-39)."""
    r = o.shape[0]
    if r <= chunk:
        return fn(o, d, t_max)
    pad = (-r) % chunk
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    t_p = jnp.pad(t_max, (0, pad))
    starts = jnp.arange((r + pad) // chunk, dtype=jnp.int32) * chunk

    def one(args):
        oo, dd, tt, start = args
        if n_alive is None:
            return fn(oo, dd, tt)
        return jax.lax.cond(start < n_alive, lambda: fn(oo, dd, tt),
                            lambda: empty(chunk))

    out = jax.lax.map(one, (o_p.reshape(-1, chunk, 3),
                            d_p.reshape(-1, chunk, 3),
                            t_p.reshape(-1, chunk), starts))
    return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:])[:r], out)


def closest_hit(o, d, scene: DeviceScene, t_min=1e-4, t_max=INF,
                chunk: int = 8192, n_alive=None) -> Hit:
    """Nearest scene hit for each ray. o, d: [R,3]; R is padded internally
    to a multiple of `chunk` and processed chunk by chunk (see _chunked).
    t_max may be per-ray [R]."""
    from ..scene.types import ensure_device
    scene = ensure_device(scene)
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                                 (o.shape[0],))
    return _chunked(
        lambda oo, dd, tt: _closest_chunk(oo, dd, scene, t_min, tt),
        o, d, t_max_arr, chunk, n_alive, _empty_hit)


def _any_chunk(o, d, scene: DeviceScene, t_min, t_max):
    tris, cones = scene.tris, scene.cones
    blocked = jnp.zeros((o.shape[0],), bool)
    if tris.count:
        tg, _, _, valid = isect.triangle_hit_grid(o, d, tris, t_min, t_max[:, None])
        blocked |= jnp.any(valid, axis=-1)
    if cones.count:
        _, _, valid = isect.cone_hit_grid(o, d, cones, t_min, t_max[:, None])
        blocked |= jnp.any(valid, axis=-1)
    return blocked


def any_hit(o, d, scene: DeviceScene, t_max, t_min=1e-4, chunk: int = 8192,
            n_alive=None):
    """Shadow-ray occlusion: does any geometry lie within (t_min, t_max)?
    t_max: [R] per-ray. The accel-structure `isIntersection` analog
    (CPU_DataStructure.h:14-30). `n_alive` as in closest_hit."""
    from ..scene.types import ensure_device
    scene = ensure_device(scene)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    return _chunked(lambda oo, dd, tt: _any_chunk(oo, dd, scene, t_min, tt),
                    o, d, t_max, chunk, n_alive,
                    lambda n: jnp.zeros((n,), bool))


def _pack_grid(pack):
    """(t_grid, valid_grid) function of one primitive pack's kind."""
    if isinstance(pack, TrianglePack):
        return lambda *a: (lambda g: (g[0], g[3]))(isect.triangle_hit_grid(*a))
    return lambda *a: (lambda g: (g[0], g[2]))(isect.cone_hit_grid(*a))


def pack_closest(o, d, pack, t_min, t_max, chunk: int):
    """Nearest hit over ONE primitive pack (TrianglePack or ConePack) by
    chunked brute force -> (t [R], row [R] int32); t is INF on a miss.
    Used for a small BVH-less pack beside a BVH'd one (the hair ball's
    scalp triangles), where one dense [R, P] grid over the whole wavefront
    would materialise R*P-sized intermediates."""
    grid = _pack_grid(pack)
    return _chunked(
        lambda oo, dd, tt: _nearest_over_grid(
            grid(oo, dd, pack, t_min, tt[:, None])[0]),
        o, d, t_max, chunk)


def pack_any(o, d, pack, t_min, t_max, chunk: int):
    """Any hit within (t_min, t_max) over ONE primitive pack -> [R] bool
    (chunked like pack_closest)."""
    grid = _pack_grid(pack)
    return _chunked(
        lambda oo, dd, tt: jnp.any(
            grid(oo, dd, pack, t_min, tt[:, None])[1], axis=-1),
        o, d, t_max, chunk)
