"""Scaling-efficiency harness: fixed-work renders over 1/2/4/... devices.

The reference's only scaling instrumentation is single-node progress/ETA
logging (/root/reference/src/libraries/KIRK/CPU/CPU_Raytracer/
CPU_PathTracer.cpp:28-41 over Threading.h:104 row shards) — it has no
multi-device scaling to measure. The rebuild's BASELINE metric is 1->N
scaling efficiency (target >=90% at 1->4 hosts), and this module is the
measurement path: strong scaling (fixed image split over more devices) of
the full sharded progressive render (`parallel.render.render_image_sharded`).

Run it on the devices of the host:

    python -m ba_pathtracing_fur.parallel.scaling            # all devices

or rehearse it on a virtual CPU mesh, which only JAX_PLATFORMS=cpu asks for:

    JAX_PLATFORMS=cpu python -m ba_pathtracing_fur.parallel.scaling --devices 8

Virtual devices share one host's cores, so their times are no measurement
of scaling.
"""

from __future__ import annotations

import time
from typing import Sequence

import jax
import jax.numpy as jnp

from ..models.pathtracer import RenderConfig
from .mesh import make_mesh
from .render import render_image_sharded


def _powers_of_two_up_to(n: int) -> list[int]:
    out, k = [], 1
    while k <= n:
        out.append(k)
        k *= 2
    return out


def measure_scaling(scene, camera, cfg: RenderConfig,
                    device_counts: Sequence[int] | None = None,
                    geo: int = 1, repeats: int = 2) -> list[dict]:
    """Strong-scaling sweep: render the SAME image on meshes of increasing
    device count; report wall time, rays/s, speedup vs 1 device, and
    parallel efficiency = speedup / n.

    Compile time is excluded (one warm-up render per mesh) — efficiency here
    is steady-state progressive-render throughput, the regime the reference's
    ETA meter tracks per sample (CPU_PathTracer.cpp:28-41).
    """
    if device_counts is None:
        device_counts = _powers_of_two_up_to(len(jax.devices()))
    if device_counts[0] != 1:
        # speedup/efficiency are defined vs the 1-device run; always
        # include it so "efficiency" means the BASELINE 1->N metric.
        device_counts = [1] + [n for n in device_counts if n > 1]
    w, h = camera.resolution
    rays = float(w * h) * cfg.spp * cfg.depth
    key = jax.random.key(0)

    rows: list[dict] = []
    t1 = None
    for n in device_counts:
        if n > len(jax.devices()):
            break
        g = geo if n % max(geo, 1) == 0 and geo <= n else 1
        mesh = make_mesh(n, geo=g)
        run = jax.jit(lambda s, k: render_image_sharded(s, camera, k, cfg, mesh))
        jax.block_until_ready(run(scene, key))  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(scene, key))
            best = min(best, time.perf_counter() - t0)
        if t1 is None:
            t1 = best
        speedup = t1 / best
        rows.append({
            "devices": n, "geo": g, "wall_s": round(best, 4),
            "rays_per_s": round(rays / best, 1),
            "speedup": round(speedup, 3),
            "efficiency": round(speedup / n, 3),
        })
    return rows


def scaling_panel(rows: list[dict]) -> dict:
    """Flatten the sweep into a report-panel dict (utils.report.add_panel)."""
    panel = {}
    for r in rows:
        panel[f"{r['devices']}dev_rays_per_s"] = r["rays_per_s"]
        panel[f"{r['devices']}dev_efficiency"] = r["efficiency"]
    return panel


def main(argv: Sequence[str] | None = None) -> None:
    import argparse
    import json
    import os
    import sys

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=None,
                   help="max device count (default: every device; with "
                        "JAX_PLATFORMS=cpu, that many virtual CPU devices)")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--scene", choices=["cornell", "fur"], default="cornell")
    p.add_argument("--geo", type=int, default=1)
    args = p.parse_args(argv)

    if args.devices and os.environ.get("JAX_PLATFORMS") == "cpu":
        # read when the CPU backend starts, which is below: the first
        # device query of this process
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}")
    n = args.devices or jax.device_count()
    if jax.device_count() < n:
        sys.exit(f"scaling: asked for {n} devices, the "
                 f"{jax.default_backend()} backend has {jax.device_count()}")

    from ..scene.builtins import cornell_box, fur_patch
    if args.scene == "fur":
        scene, camera = fur_patch(resolution=(args.res, args.res))
    else:
        scene, camera = cornell_box(resolution=(args.res, args.res))
    cfg = RenderConfig(depth=args.depth, spp=args.spp, ray_chunk=4096)
    rows = measure_scaling(scene, camera, cfg,
                           device_counts=_powers_of_two_up_to(n),
                           geo=args.geo)
    print(json.dumps({"metric": "scaling_efficiency",
                      "scene": args.scene, "res": args.res,
                      "rows": rows}))


if __name__ == "__main__":
    main()
