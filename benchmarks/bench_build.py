"""At-scale BVH build benchmark.

Builds the hair-ball cone BVH N times on the device and reports the
per-stage timings (ops/traverse.LAST_BUILD_STATS), demonstrating:
  * split reproducibility (pure host compute),
  * total build cost excluding the pack transfer (<10 s target),
  * the fingerprint perm cache (second-process builds skip the split).

Usage:  python benchmarks/bench_build.py [n_fibers] [n_repeats]
Writes out/BUILD_BENCH.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    n_fibers = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    import jax

    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene import builtins

    t0 = time.perf_counter()
    scene, _ = builtins.hair_ball(resolution=(64, 64), n_fibers=n_fibers)
    gen_s = time.perf_counter() - t0
    n_cones = int(scene.cones.count)

    def force(acc):
        jax.block_until_ready(acc)

    runs = []
    for i in range(repeats):
        os.environ["BAPT_NO_BVH_CACHE"] = "1"  # measure the REAL build
        t0 = time.perf_counter()
        acc = traverse.attach_bvh(scene, method="median")
        force(acc)
        total = time.perf_counter() - t0
        st = dict(traverse.LAST_BUILD_STATS)
        st["total"] = round(total, 2)
        st["excl_transfer"] = round(total - st.get("transfer", 0.0), 2)
        runs.append(st)
        print(f"# build {i}: {st}", file=sys.stderr)
        del acc

    os.environ.pop("BAPT_NO_BVH_CACHE", None)
    cached_runs = []
    for i in range(2):
        t0 = time.perf_counter()
        acc = traverse.attach_bvh(scene, method="median")
        force(acc)
        total = time.perf_counter() - t0
        st = dict(traverse.LAST_BUILD_STATS)
        st["total"] = round(total, 2)
        st["excl_transfer"] = round(total - st.get("transfer", 0.0), 2)
        cached_runs.append(st)
        print(f"# cached build {i}: {st}", file=sys.stderr)
        del acc

    out = {
        "n_fibers": n_fibers,
        "n_cones": n_cones,
        "scene_gen_s": round(gen_s, 2),
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "builds": runs,
        "cached_builds": cached_runs,
    }
    os.makedirs("out", exist_ok=True)
    with open("out/BUILD_BENCH.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
