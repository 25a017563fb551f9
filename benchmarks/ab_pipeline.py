"""A/B pipeline-knob benchmark: stream compaction x spp batching per scene.

This benchmark makes the two pipeline knobs data-driven: for each
BASELINE-class scene, time the full progressive render under {compact} x
{spp_batch} and report rays/s. The winning combination per scene class is
what bench.py should ship.

Reference match: compaction exists to SAVE work (pt_sortHits.compute:17-39)
— a configuration where it costs more than it saves is a bug in the policy,
not a tunable.

Usage:  python benchmarks/ab_pipeline.py [--repeats 2] [--out out/AB_PIPELINE.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def _scenes(smoke: bool):
    """(name, scene, camera, base_cfg_kwargs, bvh_method) tuples."""
    from ba_pathtracing_fur.scene.builtins import (
        cornell_box, fur_patch, tri_terrain)

    res = (64, 64) if smoke else (256, 256)
    spp = 4 if smoke else 64
    yield ("cornell_36tri", *cornell_box(resolution=res),
           dict(depth=4, spp=spp), None)

    res3 = (64, 64) if smoke else (512, 512)
    yield ("terrain_100k_bvh", *tri_terrain(resolution=res3,
                                            n_tris=2000 if smoke else 100_000),
           dict(depth=4, spp=2 if smoke else 16, ray_chunk=4096), "sah")

    yield ("fur_patch_bvh", *fur_patch(resolution=res3,
                                       fibers_per_face=4 if smoke else 2500),
           dict(depth=4, spp=2 if smoke else 8, ray_chunk=4096), "median")


def _time(fn, args, repeats):
    out = jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "out", "AB_PIPELINE.json"))
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batches", default="1,4,16",
                   help="comma-separated spp_batch values to sweep")
    args = p.parse_args(argv)

    from ba_pathtracing_fur.models.pathtracer import (
        RenderConfig, render_image)
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene.types import to_device

    batches = [int(b) for b in args.batches.split(",")]
    key = jax.random.key(0)
    table = {}
    for name, scene, camera, kw, bvh in _scenes(args.smoke):
        if bvh:
            scene = traverse.attach_bvh(scene, method=bvh)
        scene = to_device(scene)
        w, h = camera.resolution
        rows = {}
        for compact, batch in itertools.product((False, True), batches):
            spp = kw.get("spp", 8)
            if spp % batch:
                continue
            cfg = RenderConfig(compact=compact, spp_batch=batch, **kw)
            fn = jax.jit(lambda s, k, c=cfg: render_image(s, camera, k, c))
            wall = _time(fn, (scene, key), args.repeats)
            rays = w * h * spp * kw.get("depth", 4)
            rows[f"compact={int(compact)},batch={batch}"] = {
                "wall_s": round(wall, 3),
                "rays_per_s": round(rays / wall, 1),
            }
            print(f"# {name} compact={compact} batch={batch}: "
                  f"{rays/wall/1e6:.2f}M rays/s", file=sys.stderr)
        best = max(rows, key=lambda k: rows[k]["rays_per_s"])
        table[name] = {"rows": rows, "best": best,
                       "res": [w, h], "bvh": bvh or "none"}

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    payload = {"metric": "ab_pipeline",
               "platform": jax.devices()[0].platform,
               "device": jax.devices()[0].device_kind,
               "table": table}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
