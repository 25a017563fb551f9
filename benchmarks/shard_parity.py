"""Where a pixel-sharded hair-ball render departs from the one-device one.

Renders the hair ball on one device, its dp pixel slices on one device (the
split alone), and with dp devices through render_image_sharded (shard_map),
then runs bounce 1 from one shared state under jit and under shard_map and
compares the hits, the BSDF samples and the new ray state field by field,
and the bounce-1 hits and shadow flags with the cones split over two geo
shards (dp/2 x geo=2, per-shard BVHs) against the one-device ones.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python benchmarks/shard_parity.py

Prints one line per comparison: elements not bitwise equal and max |d|.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: A hair ball dense enough that grazing hits re-route some paths, small
#: enough for the CPU in about 30 s; ray chunks below the per-device count.
FIBERS, RES, CHUNK, DP = 20000, 128, 1024, 4


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from ba_pathtracing_fur.core import camera as cam_mod, rng
    from ba_pathtracing_fur.core import vecmath as vm
    from ba_pathtracing_fur.models import bsdf, fur
    from ba_pathtracing_fur.models import pathtracer as pt
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.parallel import make_mesh, render_image_sharded
    from ba_pathtracing_fur.parallel.render import (
        geo_closest_fn, geo_occlude_fn, scene_partition_specs,
        shard_scene_bvh)
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    res, dp, chunk = RES, DP, CHUNK
    scene0, camera = builtins.hair_ball(resolution=(res, res),
                                        n_fibers=FIBERS, on_device=True)
    scene = to_device(traverse.attach_bvh(
        scene0, method="median",
        cone_split_hint=dict(builtins.LAST_HAIRBALL_GEN)))
    cfg = pt.RenderConfig(depth=4, spp=1, ray_chunk=chunk,
                          compact=False)
    key = jax.random.key(2)
    closest = geo_closest_fn(None, chunk)
    occlude = geo_occlude_fn(None, chunk)
    mesh = make_mesh(dp, geo=1)

    def report(name, a, b):
        a, b = np.asarray(a), np.asarray(b)
        d = np.abs(a.astype(np.float64) - b)
        print(f"{name}: {int(np.sum(a != b))} of {a.size} elements not "
              f"bitwise equal, max|d| {float(d.max()):.3e}", flush=True)

    full = np.asarray(pt.render_image(scene, camera, key, cfg))
    q = res * res // dp
    part = jax.jit(lambda s, ids: pt.render_sample_ids(
        s, camera, ids, key, 0, cfg, closest_fn=closest, occlude_fn=occlude))
    split = np.concatenate([np.asarray(part(scene, jnp.arange(i * q,
                                                              (i + 1) * q)))
                            for i in range(dp)]).reshape(full.shape)
    report(f"one device, {dp} pixel slices vs whole", split, full)
    sharded = jax.jit(lambda s, k: render_image_sharded(
        s, camera, k, cfg, mesh))(scene, key)
    report(f"dp={dp} shard_map vs one device", sharded, full)
    report(f"dp={dp} shard_map vs {dp} slices", sharded, split)

    # bounce 1 from one state: jit vs shard_map, same inputs
    w = res
    ids = jnp.arange(res * res)
    keys = rng.keys_for_pixels(key, ids, 0)
    o, d = cam_mod.rays_from_pixels(
        camera, (ids % w).astype(jnp.float32), (ids // w).astype(jnp.float32),
        rng.bounce_uniform(keys, -1, 2, tag=7))
    st = jax.jit(lambda s, k, sc: pt.trace_bounce(
        s, sc, k, 0, cfg, closest, occlude))(pt.init_state(o, d), keys, scene)

    def bounce1(s, k, sc):
        hit = closest(s.origin, s.direction, sc)
        v3 = hit.valid[:, None]
        up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
        n = jnp.where(v3, hit.normal, up)
        fu = jnp.where(v3, hit.fiber_u, jnp.array([1.0, 0.0, 0.0]))
        fv = jnp.where(v3, hit.fiber_v, up)
        fw = jnp.where(v3, hit.fiber_w, jnp.array([0.0, 0.0, 1.0]))
        mp = bsdf.gather_materials(sc.materials, hit.mat_id, hit.uv,
                                   sc.textures, sc.tex_slots)
        wi = -vm.normalize(s.direction)
        bs = bsdf.sample_surface(mp, wi, n, rng.bounce_uniform(k, 1, 2, tag=0),
                                 s.flags, present=sc.bsdfs_present)
        hs = fur.sample_hair(mp, wi, n, fu, fv, fw, s.flags,
                             jnp.zeros_like(s.flags))
        out = pt.trace_bounce(s, sc, k, 1, cfg, closest, occlude)
        return {"hit t": hit.t, "hit prim": hit.prim_id,
                "surface wo": bs.wo, "hair wo": hs.wo,
                "hair reflectance": hs.reflectance,
                "state direction": out.direction,
                "state radiance": out.radiance, "state color": out.color}

    row = lambda tree: jax.tree.map(lambda _: P("dp"), tree)
    a = jax.jit(bounce1)(st, keys, scene)
    b = jax.jit(jax.shard_map(
        bounce1, mesh=mesh,
        in_specs=(row(st), P("dp"), scene_partition_specs(scene)),
        out_specs=P("dp"), check_vma=False))(st, keys, scene)
    for k in a:
        report(f"bounce 1 {k}, shard_map vs jit", b[k], a[k])

    gscene = shard_scene_bvh(scene0, 2)
    gmesh = make_mesh(dp, geo=2)

    def hits(s, sc, geo_axis):
        h = geo_closest_fn(geo_axis, chunk)(s.origin, s.direction, sc)
        to_l = sc.lights.position[0][None] - s.origin
        dist = jnp.linalg.norm(to_l, axis=-1)
        blocked = geo_occlude_fn(geo_axis, chunk)(
            s.origin, to_l / dist[:, None], sc, dist)
        return {"hit t": h.t, "hit prim": h.prim_id, "hit type": h.prim_type,
                "shadow flag": blocked}

    a = jax.jit(lambda s, sc: hits(s, sc, None))(st, scene)
    b = jax.jit(jax.shard_map(
        lambda s, sc: hits(s, sc, "geo"), mesh=gmesh,
        in_specs=(row(st), scene_partition_specs(gscene)),
        out_specs=P("dp"), check_vma=False))(st, gscene)
    for k in a:
        report(f"bounce 1 {k}, dp={dp // 2} x geo=2 vs one device",
               b[k], a[k])


if __name__ == "__main__":
    main()
