"""Multi-device sharded rendering: DP over pixels × geometry sharding.

From-scratch distributed layer (the reference is single-node threads only,
SURVEY §2.4). Strategy per SURVEY §7 step 7:

  * pixels sharded over the "dp" mesh axis (each device renders its rays —
    the multi-chip analog of `ThreadManager::for_loop_double` row sharding,
    /root/reference/src/libraries/KIRK/Utils/Threading.h:104);
  * scene primitive packs optionally sharded over the "geo" axis when the
    triangle/cone arrays exceed per-chip HBM; each device intersects its
    local shard and nearest hits are merged with an all_gather + argmin
    (min-reduction with payload), shadow occlusion with a psum-OR;
  * materials / lights / environment / textures are replicated.

Everything is one `shard_map`-wrapped XLA program per sample, so the bounce
loop never leaves the device and all cross-device traffic is XLA
collectives.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import camera as cam_mod
from ..models.pathtracer import RenderConfig, render_sample_ids
from ..ops import bruteforce
from ..scene.types import ConePack, DeviceScene, TrianglePack
from .mesh import DP_AXIS, GEO_AXIS


# ---------------------------------------------------------------------------
# Geometry padding / sharding
# ---------------------------------------------------------------------------

def _pad_tris(tris: TrianglePack, to: int) -> TrianglePack:
    """Pad with degenerate (all-zero) triangles: det==0 ⇒ never hit."""
    pad = to - tris.count
    if pad <= 0:
        return tris
    return jax.tree.map(lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)), tris)


def _pad_cones(cones: ConePack, to: int) -> ConePack:
    """Pad with inert cones whose axis slab is empty (min_d > max_d)."""
    pad = to - cones.count
    if pad <= 0:
        return cones
    padded = jax.tree.map(lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)), cones)
    min_d = padded.min_d.at[cones.count:].set(1.0)
    max_d = padded.max_d.at[cones.count:].set(-1.0)
    return padded.replace(min_d=min_d, max_d=max_d)


def pad_scene_geo(scene: DeviceScene, n_geo: int) -> DeviceScene:
    """Pad primitive counts to multiples of n_geo so packs split evenly."""
    def up(n):
        return int(-(-max(n, 1) // n_geo) * n_geo)

    return scene.replace(
        tris=_pad_tris(scene.tris, up(scene.tris.count)),
        cones=_pad_cones(scene.cones, up(scene.cones.count)),
    )


def scene_geo_bytes(scene: DeviceScene) -> int:
    """Bytes of per-device primitive-pack storage (the arrays that the
    "geo" axis shards). BVH layouts scale with the same factor, so this is
    the capacity-planning number for SURVEY §2.4's sharded-scene row."""
    total = 0
    for pack in (scene.tris, scene.cones):
        for leaf in jax.tree.leaves(pack):
            total += leaf.size * leaf.dtype.itemsize
    return total


def required_geo(scene: DeviceScene, per_device_budget_bytes: int,
                 max_geo: int = 64) -> int:
    """Smallest power-of-two geo factor whose per-device pack slice fits
    `per_device_budget_bytes`. THE point of the geo axis: it is a CAPACITY
    axis, not a speed axis — at scales where one device holds the scene,
    sharding only adds the cross-shard hit merge; when the scene does NOT
    fit, it is what makes the render possible at all (SURVEY §2.4). Raises
    if even max_geo shards don't fit."""
    need = scene_geo_bytes(scene)
    g = 1
    while need > per_device_budget_bytes * g:
        g *= 2
        if g > max_geo:
            raise ValueError(
                f"scene packs ({need / 1e6:.0f} MB) exceed "
                f"{max_geo} x {per_device_budget_bytes / 1e6:.0f} MB")
    return g


def scene_partition_specs(scene: DeviceScene, geo_axis: str = GEO_AXIS):
    """PartitionSpec pytree matching `scene`: primitive packs sharded on
    their leading dim over `geo_axis`, everything else replicated."""
    geo = lambda tree: jax.tree.map(lambda _: P(geo_axis), tree)
    repl = lambda tree: jax.tree.map(lambda _: P(), tree)
    # BVHs: replicated when global (dp-only fast path); sharded on their
    # leading stack axis when built per geo shard by shard_scene_bvh
    def bvh_spec(b):
        if b is None:
            return None
        stacked = getattr(b, "geo_stacked", False)
        return jax.tree.map(lambda _: P(geo_axis) if stacked else P(), b)

    return DeviceScene(
        tris=geo(scene.tris),
        cones=geo(scene.cones),
        materials=repl(scene.materials),
        lights=repl(scene.lights),
        env=repl(scene.env),
        textures=None if scene.textures is None else P(),
        tri_bvh=bvh_spec(scene.tri_bvh),
        cone_bvh=bvh_spec(scene.cone_bvh),
        # static metadata must match the scene's treedef exactly
        has_hair=scene.has_hair,
        tex_slots=scene.tex_slots,
        bsdfs_present=scene.bsdfs_present,
    )


def shard_scene_bvh(scene: DeviceScene, n_geo: int, method: str = "median",
                    leaf_size: int | None = None,
                    fanout: int | None = None) -> DeviceScene:
    """Prepare a geometry-sharded scene with one BVH per shard.

    The multi-chip composition of the runtime accel swap (Demo/main.cpp:
    94-127 under Threading.h:104 in the reference; VERDICT r1 missing #4):
    each geo shard gets its own LBVH over its primitive range, so a
    geo-sharded 1M-fiber render traverses instead of brute-forcing.

    Packs are padded to n_geo equal ranges; each range is BVH-reordered so
    shard i's rows are exactly rows [i*S, (i+1)*S) of the concatenated
    pack (S = slots per shard — the natural P("geo") partition). The BVH
    arrays carry a leading [n_geo] stack axis (marked geo_stacked) sharded
    over "geo" and squeezed in-shard. perm maps slot -> GLOBAL original
    primitive id. All shards share (n_leaves, leaf_size, fanout), so the
    stacked pytrees are rectangular.
    """
    from ..ops import bvh as bvh_mod, intersect as isect, traverse
    scene = pad_scene_geo(scene, n_geo)

    def build_stack(pack, aabb_fn, reorder_fn, pack_fn, min_prims=1):
        n = pack.count
        if n < max(min_prims, n_geo):
            return pack, None
        m = n // n_geo
        host = jax.tree.map(np.asarray, pack)
        k = leaf_size or traverse.auto_leaf_size(m)
        build = traverse.ACCEL_BUILDERS[method]
        shard_bvhs = []
        shard_packs = []
        for i in range(n_geo):
            rng_pack = jax.tree.map(lambda x: x[i * m:(i + 1) * m], host)
            bmin, bmax = aabb_fn(rng_pack)
            b = build(bmin, bmax, k)
            f = (traverse.auto_fanout(b.n_leaves) if fanout is None
                 else fanout)
            b = b.replace(fanout=f)
            rp = reorder_fn(rng_pack, b)
            b = pack_fn(rp, b)
            # globalize perm (slot -> original id in the unsharded pack)
            perm = np.asarray(b.perm)
            b = b.replace(perm=np.where(perm >= 0, perm + i * m, -1)
                          .astype(np.int32))
            shard_bvhs.append(b)
            shard_packs.append(rp)
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *shard_bvhs)
        stacked = stacked.replace(geo_stacked=True)
        cat_pack = jax.tree.map(lambda *xs: np.concatenate(xs), *shard_packs)
        return cat_pack, stacked

    tris, tri_bvh = build_stack(scene.tris, isect.triangle_aabbs,
                                bvh_mod.reorder_tris, bvh_mod.pack_tris)
    cones, cone_bvh = build_stack(scene.cones, isect.cone_aabbs,
                                  bvh_mod.reorder_cones, bvh_mod.pack_cones)
    return scene.replace(tris=tris, cones=cones, tri_bvh=tri_bvh,
                         cone_bvh=cone_bvh)


def _squeeze_local_bvhs(scene: DeviceScene) -> DeviceScene:
    """Inside the shard: drop the leading geo stack axis (size 1 locally)
    from geo-stacked BVHs so ops.traverse sees ordinary BVH pytrees."""
    def sq(b):
        if b is None or not getattr(b, "geo_stacked", False):
            return b
        return jax.tree.map(lambda x: x[0], b).replace(geo_stacked=False)

    return scene.replace(tri_bvh=sq(scene.tri_bvh),
                         cone_bvh=sq(scene.cone_bvh))


# ---------------------------------------------------------------------------
# Geo-merged intersection (inside shard_map)
# ---------------------------------------------------------------------------

def _merge_hits_over_geo(hit: bruteforce.Hit, axis: str) -> bruteforce.Hit:
    """Min-reduction with payload over the geo axis: gather every shard's
    nearest hit and keep the globally nearest per ray.

    Tie-break parity with the single-device merge (_assemble_hit's
    `cone_wins = t_cone < t_tri`): at EQUAL t a triangle beats a cone.
    A plain argmin over shards picks the lowest shard instead, which
    inverts that rule whenever the tied tri and cone live in different
    shards — real at fur contact points, where fiber bases lie exactly on
    their ground triangles (one-pixel diffs at ~100+ fibers, r4 finding).
    Same-type ties keep lowest-shard = lowest-global-index, also matching
    the single-device argmin."""
    g = jax.lax.all_gather(hit, axis)  # [G, R, ...]
    tmin = jnp.min(g.t, axis=0)  # [R]
    cand = g.t == tmin[None, :]  # [G, R] shards at the min
    tri_cand = cand & (g.prim_type != bruteforce.PRIM_CONE)
    use_tri = jnp.any(tri_cand, axis=0)
    # argmax of bool = FIRST True = lowest shard among the candidates
    win = jnp.where(use_tri, jnp.argmax(tri_cand, axis=0),
                    jnp.argmax(cand, axis=0))
    r = win.shape[0]
    rows = jnp.arange(r)

    def pick(x):
        return x[win, rows] if x.ndim == 2 else x[win, rows, ...]

    return jax.tree.map(pick, g)


def geo_closest_fn(axis: str | None, chunk: int):
    """closest_fn for trace_bounce: local accel-dispatched intersection
    (LBVH traversal when the shard carries one, brute force otherwise —
    ops.traverse.closest_hit) + geo merge."""
    from ..ops import traverse

    def fn(o, d, scene):
        hit = traverse.closest_hit(o, d, _squeeze_local_bvhs(scene),
                                   chunk=chunk)
        if axis is None:
            return hit
        return _merge_hits_over_geo(hit, axis)

    return fn


def geo_occlude_fn(axis: str | None, chunk: int):
    """occlude_fn for calc_direct_light: psum-OR of local occlusion."""
    from ..ops import traverse

    def fn(o, d, scene, t_max):
        blocked = traverse.any_hit(o, d, _squeeze_local_bvhs(scene), t_max,
                                   chunk=chunk)
        if axis is None:
            return blocked
        return jax.lax.psum(blocked.astype(jnp.int32), axis) > 0

    return fn


# ---------------------------------------------------------------------------
# Sharded render
# ---------------------------------------------------------------------------

def render_image_sharded(scene: DeviceScene, camera: cam_mod.Camera, key,
                         cfg: RenderConfig, mesh) -> jnp.ndarray:
    """Full progressive render sharded over `mesh` -> [H,W,3].

    The same estimator as models.pathtracer.render_image for any mesh
    shape: RNG keys are global-pixel-id keyed and the geo hit merge
    reproduces the single-device argmin exactly. XLA may round the sharded
    program's shading differently (ulps per bounce, which a later grazing
    hit can turn into another path; benchmarks/shard_parity.py shows it),
    so images agree to float tolerance, not always bit for bit.
    """
    w, h = camera.resolution
    r = w * h
    n_dp = mesh.shape[DP_AXIS]
    n_geo = mesh.shape.get(GEO_AXIS, 1)
    if r % n_dp != 0:
        raise ValueError(f"pixel count {r} not divisible by dp={n_dp}")
    scene = pad_scene_geo(scene, n_geo)
    geo = GEO_AXIS if n_geo > 1 else None

    closest = geo_closest_fn(geo, cfg.ray_chunk)
    occlude = geo_occlude_fn(geo, cfg.ray_chunk)

    def shard_fn(pixel_ids, scene_shard):
        def body(i, acc):
            c = render_sample_ids(scene_shard, camera, pixel_ids, key, i, cfg,
                                  closest_fn=closest, occlude_fn=occlude)
            return acc + (c - acc) / (i + 1.0)

        init = jnp.zeros((pixel_ids.shape[0], 3), jnp.float32)
        # trip-count-1 elision (see models.pathtracer.render_image)
        return body(0, init) if cfg.spp == 1 else jax.lax.fori_loop(
            0, cfg.spp, body, init)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(DP_AXIS), scene_partition_specs(scene)),
        out_specs=P(DP_AXIS),
        check_vma=False,
    )
    acc = mapped(jnp.arange(r), scene)
    img = acc.reshape(h, w, 3)
    if cfg.tonemap:
        from ..ops import tonemap
        img = tonemap.tonemap(img)
    return img


def render_image_sharded_jit(scene, camera, key, cfg: RenderConfig, mesh):
    """jit-wrapped render_image_sharded (camera/cfg/mesh static)."""
    fn = jax.jit(partial(render_image_sharded, camera=camera, cfg=cfg, mesh=mesh))
    return fn(scene, key=key)
