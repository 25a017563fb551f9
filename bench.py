"""Headline benchmark: rays/s + MFU on the BASELINE.json configs.

Prints ONE JSON line with the headline metric (config-1 Cornell rays/s, the
metric tracked since round 1) plus a `configs` table covering BASELINE
configs 0-5. The reference publishes no numbers (BASELINE.md): its README
defers to a dead wiki. `vs_baseline` is measured-vs-measured: the
denominator is the committed out/CPU_BASELINE.json (benchmarks/
cpu_baseline.py — the same renderer run single-host on XLA:CPU at
KIRK-parity settings, the stand-in for the reference's thread-pooled C++
tracer).

MFU here = FLOPs / wall / the card's float32 peak outside the tensor cores
(PEAKS, keyed by device_kind; an unknown device is an error). A ray tracer
is float32 vector and gather work, so a small MFU is expected — the number
is tracked to catch regressions and to compare kernel variants, not to
approach 1.0. Every output line names the device and the card's power
limit; a run that finds no GPU fails.

Env knobs:
  BENCH_SMOKE=1     tiny shapes (CI smoke)
  BENCH_CONFIGS=1,4 comma-separated subset (default "0,1,2,3,4,5")
  BENCH_HAIRBALL_FIBERS / BENCH_HAIRBALL_SPP override config 5's scale
"""

from __future__ import annotations

import json
import os
import sys
import time

def _cpu_baseline_rays_per_s(config: str = "cornell_diffuse") -> float | None:
    """Measured CPU baseline rate for a config (out/CPU_BASELINE.json),
    or None when the file hasn't been generated on this host yet."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "out", "CPU_BASELINE.json")
    try:
        with open(path) as f:
            data = json.load(f)
        return float(data["configs"][config]["rays_per_s"])
    except (OSError, KeyError, ValueError):
        return None

#: Published peaks by JAX device_kind: float32 FLOP/s outside the tensor
#: cores and device-memory bytes/s, at the full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM part (dense, 700 W)"},
}


def device_peaks(device) -> dict:
    """PEAKS entry of `device`; KeyError for a device not in the table."""
    kind = getattr(device, "device_kind", "")
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device_kind {kind!r}; add it to "
                       f"bench.PEAKS with its source")
    return PEAKS[kind]


def card_info() -> str:
    """`nvidia-smi` name and power limit of the card(s)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


#: Analytic FLOPs per primitive intersection test (hand count of the
#: straight-line kernel math: Möller-Trumbore _tri_core ~55 mul/add/div,
#: cone quadratic _cone_core ~90 incl. frame projection + slab) — used for
#: the brute-force configs, whose FLOP count IS rays x prims x test (every
#: ray tests every primitive each bounce, plus O(100)/ray shading noise).
FLOPS_TRI_TEST = 55.0
FLOPS_CONE_TEST = 90.0


def _measure(fn, args, rays: int, peak: float, analytic_flops=None):
    """Compile, warm, time; returns dict(rays_per_s, mfu, wall_s, flops).

    MFU source, in order (no fabricated zeros): XLA cost_analysis when it
    reports FLOPs; else the caller's analytic count (exact for brute-force
    configs); else None (serialized as null — BVH traversal FLOPs are
    schedule-dependent and cannot be claimed statically)."""
    import jax

    jfn = jax.jit(fn)
    cost = jfn.lower(*args).compile().cost_analysis() or {}
    flops = float(cost.get("flops", 0.0))
    flops_src = "xla_cost_analysis"
    if not flops and analytic_flops:
        flops, flops_src = float(analytic_flops), "analytic"

    def run():
        return jax.block_until_ready(jfn(*args))

    run()  # warm (compile is cached from the lower() above)
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    return {
        "rays_per_s": rays / wall,
        "mfu": (flops / wall / peak) if flops else None,
        "mfu_source": flops_src if flops else None,
        "wall_s": wall,
        "flops": flops,
    }


def bench_cornell(smoke, peak, variant="diffuse"):
    """Configs 1 and 2. Compaction and spp batching are off: the
    brute-force wavefront fills the device on its own (not yet re-measured
    on the GPU; benchmarks/ab_pipeline.py sweeps both)."""
    import jax

    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    from ba_pathtracing_fur.scene.builtins import cornell_box
    from ba_pathtracing_fur.scene.types import to_device

    if variant == "diffuse":
        res, spp, depth, mis = (64, 64) if smoke else (256, 256), \
            4 if smoke else 64, 4, False
    else:
        res, spp, depth, mis = (64, 64) if smoke else (512, 512), \
            4 if smoke else 128, 4, True

    scene, camera = cornell_box(resolution=res, variant=variant)
    scene = to_device(scene)
    # fused_shading: the level-2 full-bounce kernel fuses traversal + shade
    # + shadow for brute-force scenes
    cfg = RenderConfig(depth=depth, spp=spp, ray_chunk=res[0] * res[1],
                       spp_batch=1, compact=False, mis=mis, rr=mis,
                       fused_shading=True)
    key = jax.random.key(0)
    rays = res[0] * res[1] * spp * depth
    m = _measure(lambda s, k: render_image(s, camera, k, cfg), (scene, key),
                 rays, peak,
                 analytic_flops=rays * scene.tris.count * FLOPS_TRI_TEST)
    m.update(res=list(res), spp=spp, depth=depth)
    return m


def bench_tri_scene(smoke, peak):
    """Config 3: BVH over ~100k triangles (textured OBJ-class scene)."""
    import jax

    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene.builtins import tri_terrain
    from ba_pathtracing_fur.scene.types import to_device

    res = (64, 64) if smoke else (512, 512)
    spp = 2 if smoke else 16
    depth = 4
    n = 2000 if smoke else 100_000
    scene, camera = tri_terrain(resolution=res, n_tris=n)
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="sah")
    build_s = time.perf_counter() - t0  # host SAH + reorder/pack (numpy)
    tri_stages = dict(traverse.LAST_BUILD_STATS)
    scene = to_device(scene)
    cfg = RenderConfig(depth=depth, spp=spp, ray_chunk=65536, compact=False)
    key = jax.random.key(0)
    rays = res[0] * res[1] * spp * depth
    m = _measure(lambda s, k: render_image(s, camera, k, cfg), (scene, key),
                 rays, peak)
    m.update(res=list(res), spp=spp, depth=depth, n_tris=scene.tris.count,
             bvh_build_s=round(build_s, 2))
    if tri_stages:
        m["bvh_build_stages"] = tri_stages
    return m


def _warm_build_caches():
    """Warm first-use costs OUT of the timed builds: a cold host folds the
    g++ compile of the native splitter plus the XLA compiles of the
    pack/reorder programs into the first build. One tiny throwaway build
    per primitive kind pays those costs here; the timed builds then measure
    build work. Idempotent and ~free when warm."""
    import numpy as np

    from ba_pathtracing_fur import native
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene import builtins

    native.load()  # g++ compile of the median splitter, if cold
    sc, _ = builtins.fur_patch(resolution=(32, 32), fibers_per_face=200)
    traverse.attach_bvh(sc, method="median")
    sc, _ = builtins.tri_terrain(resolution=(32, 32), n_tris=4096)
    traverse.attach_bvh(sc, method="sah")


def bench_fur(smoke, peak, n_fibers, res, spp, name):
    """Configs 4 (fur patch) and 5 (hair ball); BENCH_HAIRBALL_SPP
    overrides the hair ball's spp."""
    import jax

    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    depth = 4
    hint = None
    if name == "fur_patch":
        fpf = max(n_fibers // 2, 1)
        scene, camera = builtins.fur_patch(resolution=res, fibers_per_face=fpf)
    else:
        # fibers generated ON DEVICE (threefry draws -> one jit), so there
        # is no 600 MB pack upload and bvh_build_s measures split+device
        # work
        scene, camera = builtins.hair_ball(resolution=res, n_fibers=n_fibers,
                                           on_device=True)
        hint = dict(builtins.LAST_HAIRBALL_GEN)
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="median",
                                cone_split_hint=hint)
    jax.block_until_ready(scene)
    build_s = time.perf_counter() - t0
    scene = to_device(scene)
    # XLA traversal in 64k-ray chunks, fused (XLA) shade stage; neither
    # chunk nor compaction has been swept on the GPU yet
    cfg = RenderConfig(depth=depth, spp=spp, ray_chunk=65536, compact=False,
                       fused_shading=True)
    key = jax.random.key(0)
    rays = res[0] * res[1] * spp * depth
    m = _measure(lambda s, k: render_image(s, camera, k, cfg), (scene, key),
                 rays, peak)
    m.update(res=list(res), spp=spp, depth=depth, n_cones=scene.cones.count,
             bvh_build_s=round(build_s, 2))
    if traverse.LAST_BUILD_STATS:
        m["bvh_build_stages"] = dict(traverse.LAST_BUILD_STATS)
    return m


def bench_reference_default(smoke, peak):
    """The reference Demo's own default workload: 1280x720, 100 spp, depth 5
    (/root/reference/src/executables/Demo/main.cpp:209-210) on the Cornell
    scene — the closest in-repo stand-in for its default JSON scene."""
    import jax

    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    from ba_pathtracing_fur.scene.builtins import cornell_box
    from ba_pathtracing_fur.scene.types import to_device

    res = (128, 72) if smoke else (1280, 720)
    spp, depth = (4, 5) if smoke else (100, 5)
    scene, camera = cornell_box(resolution=res)
    scene = to_device(scene)
    # level-2 fused bounce kernel
    cfg = RenderConfig(depth=depth, spp=spp, ray_chunk=res[0] * res[1],
                       spp_batch=1, compact=False, fused_shading=True)
    key = jax.random.key(0)
    rays = res[0] * res[1] * spp * depth
    m = _measure(lambda s, k: render_image(s, camera, k, cfg), (scene, key),
                 rays, peak,
                 analytic_flops=rays * scene.tris.count * FLOPS_TRI_TEST)
    m.update(res=list(res), spp=spp, depth=depth)
    return m


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {dev.platform}")
    peak = device_peaks(dev)["fp32_flops"]
    card = card_info()
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    which = set((os.environ.get("BENCH_CONFIGS") or "0,1,2,3,4,5").split(","))

    results = {}
    t_start = time.perf_counter()
    if which & {"3", "4", "5"}:
        _warm_build_caches()
    if "0" in which:
        results["reference_default_720p"] = bench_reference_default(smoke, peak)
    if "1" in which:
        results["cornell_diffuse"] = bench_cornell(smoke, peak, "diffuse")
    if "2" in which:
        results["cornell_glossy_mis"] = bench_cornell(smoke, peak, "glossy")
    if "3" in which:
        results["tri_100k_bvh"] = bench_tri_scene(smoke, peak)
    if "4" in which:
        n = 200 if smoke else 5000
        results["fur_patch"] = bench_fur(
            smoke, peak, n, (64, 64) if smoke else (512, 512),
            2 if smoke else 8, "fur_patch")
    if "5" in which:
        n = int(os.environ.get("BENCH_HAIRBALL_FIBERS",
                               "2000" if smoke else "1000000"))
        spp = int(os.environ.get("BENCH_HAIRBALL_SPP", "1" if smoke else "16"))
        results["hair_ball_1m"] = bench_fur(
            smoke, peak, n, (64, 64) if smoke else (1024, 1024), spp,
            "hair_ball")

    if os.environ.get("BENCH_PROFILE") == "1":
        # capture a jax.profiler trace of one tri-BVH render (SURVEY §5's
        # first-class metric pair: rays/s + trace) -> out/profile/
        from ba_pathtracing_fur.models.pathtracer import (
            RenderConfig, render_image)
        from ba_pathtracing_fur.ops import traverse
        from ba_pathtracing_fur.scene.builtins import tri_terrain
        from ba_pathtracing_fur.scene.types import to_device
        from ba_pathtracing_fur.utils import profiling

        sc, cam = tri_terrain(resolution=(256, 256), n_tris=100_000)
        sc = to_device(traverse.attach_bvh(sc, method="sah"))
        cfg = RenderConfig(depth=4, spp=2, ray_chunk=2048, compact=True)
        pfn = jax.jit(lambda s, k: render_image(s, cam, k, cfg))
        summary = profiling.profile_call(pfn, sc, jax.random.key(0),
                                         logdir="out/profile")
        with open("out/PROFILE_SUMMARY.json", "w") as f:
            json.dump(summary, f, indent=1)
        print(f"# profiler trace: {summary['logdir']} "
              f"({len(summary['files'])} files)", file=sys.stderr)

    if not results:
        print(json.dumps({"metric": "none", "value": 0, "unit": "rays/s",
                          "vs_baseline": None, "configs": {}}))
        return

    head = results.get("cornell_diffuse") or next(iter(results.values()))
    base = _cpu_baseline_rays_per_s("cornell_diffuse")
    # per-config measured speedups vs the CPU baseline where available
    for name, v in results.items():
        b = _cpu_baseline_rays_per_s(name)
        if b:
            v["vs_cpu_baseline"] = round(v["rays_per_s"] / b, 2)
    line = {
        "metric": ("cornell_smoke_rays_per_s" if smoke
                   else "cornell_256_64spp_rays_per_s"),
        "value": round(head["rays_per_s"], 1),
        "unit": "rays/s",
        "vs_baseline": (round(head["rays_per_s"] / base, 3) if base
                        else None),
        "configs": {
            k: {"rays_per_s": round(v["rays_per_s"], 1),
                "mfu": (round(v["mfu"], 7) if v["mfu"] is not None else None),
                "wall_s": round(v["wall_s"], 3),
                **{kk: v[kk] for kk in ("mfu_source", "res", "spp", "depth",
                                        "n_cones", "n_tris", "bvh_build_s",
                                        "bvh_build_stages",
                                        "vs_cpu_baseline")
                   if kk in v and v[kk] is not None}}
            for k, v in results.items()
        },
        "platform": dev.platform,
        "device": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "peak_fp32_flops": peak,
        "total_bench_s": round(time.perf_counter() - t_start, 1),
    }
    print(json.dumps(line))
    for k, v in results.items():
        mfu = "null" if v["mfu"] is None else f"{v['mfu']:.2e}"
        print(f"# {k}: {v['rays_per_s']/1e6:.2f}M rays/s  mfu={mfu} "
              f"wall={v['wall_s']:.2f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
