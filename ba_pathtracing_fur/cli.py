"""Command-line interface — the Demo + objToBinaryConverter executables.

Parity targets:
  * Demo/main.cpp:185-210 flags: -s scene, -r samples, -w/-h resolution;
    extended with depth/output/engine/fur/device options that the reference
    exposes through ImGui instead (CPU_PathTracer.cpp:262-299).
  * objToBinaryConverter/main.cpp:14-44: `convert in.obj out.b3df`.

Usage:
  python -m ba_pathtracing_fur.cli render -s cornell -r 64 -W 256 -H 256 -o out.png
  python -m ba_pathtracing_fur.cli render -s scene.json --engine whitted -o out.png
  python -m ba_pathtracing_fur.cli convert bunny.obj bunny.b3df
"""

from __future__ import annotations

import argparse
import sys


def _build_scene(args):
    from .scene import builtins
    res = (args.width, args.height)
    if args.scene == "cornell":
        return builtins.cornell_box(resolution=res)
    if args.scene == "cornell_glossy":
        return builtins.cornell_box(resolution=res, variant="glossy")
    if args.scene == "fur_patch":
        return builtins.fur_patch(resolution=res)
    if args.scene == "hair_ball":
        return builtins.hair_ball(resolution=res)
    # JSON scene file
    from .scene.graph import flatten
    from .scene.io import load_scene_json
    graph = load_scene_json(args.scene)
    if args.fur:
        n, v, r = args.fur.split(",")
        graph.add_fur_fibers_to_all_meshes(int(n), int(v), float(r))
    scene, cam = flatten(graph)
    if cam is None:
        from .core.camera import make_camera
        cam = make_camera(position=(0, 0, 3.4), look_at=(0, 0, -1),
                          resolution=res)
    else:
        import dataclasses
        cam = cam.replace(resolution=res)
    return scene, cam


def cmd_render(args) -> int:
    import jax
    import numpy as np

    from .models.pathtracer import RenderConfig, render_progressive
    from .ops import traverse
    from .utils import clock as clock_mod, film, log

    scene, camera = _build_scene(args)
    build_time = None
    if args.accel != "none":
        build_clock = clock_mod.Clock()
        scene = traverse.attach_bvh(scene, method=args.accel)
        build_time = round(build_clock.elapsed(), 3)
        log.log_info("accel build (%): %s", args.accel, build_time)
    from .scene.types import to_device
    scene = to_device(scene)  # one batched host->HBM transfer

    w, h = camera.resolution
    if args.engine == "whitted":
        from .models.whitted import WhittedConfig, render_whitted_jit
        cfg = WhittedConfig(depth=args.depth, supersamples=args.supersamples,
                            hair_lobes=args.hair_lobes)
        dc = clock_mod.DeviceClock()
        img = render_whitted_jit(scene, camera, cfg)
        log.log_info("whitted render: %s (% Mrays/s)", round(dc.stop(img), 3),
                     round(w * h / dc.elapsed() / 1e6, 2))
        img = np.asarray(img)
    else:
        cfg = RenderConfig(depth=args.depth, spp=args.samples,
                           ray_chunk=args.ray_chunk, tonemap=False)
        prog = clock_mod.RenderProgress(args.samples, w * h * args.depth,
                                        log_every=max(1, args.samples // 10))
        img = None
        for i, acc in render_progressive(scene, camera, jax.random.key(args.seed), cfg):
            prog.update(1, acc)
            img = acc
        img = np.asarray(img)

    if args.tonemap:
        from .ops import tonemap as tm
        img = np.asarray(tm.tonemap(img, tm.TonemapParams(gamma=2.2)))
        film.write_png(args.output, img, gamma=1.0)
    else:
        film.write_png(args.output, img)
    log.log_info("wrote %", args.output)

    if args.report:
        from .utils.report import RenderReport
        rep = RenderReport(title=f"{args.scene} — {args.engine}")
        rep.add_image("render", img, gamma=1.0 if args.tonemap else 2.2)
        rep.add_panel("render settings", {
            "scene": args.scene, "engine": args.engine,
            "resolution": f"{w}×{h}", "samples": args.samples,
            "depth": args.depth, "accel": args.accel, "seed": args.seed,
            "tonemap": args.tonemap,
        })
        if scene.tri_bvh is not None or scene.cone_bvh is not None:
            from .ops import bvh as bvh_mod, visualize
            for name, b in (("triangles", scene.tri_bvh),
                            ("cones", scene.cone_bvh)):
                if b is None:
                    continue
                info = bvh_mod.debug_info(b)
                if build_time is not None:
                    # combined wall time of ALL builds in attach_bvh, not a
                    # per-structure metric (ADVICE r1)
                    info["total_build_s"] = build_time
                rep.add_panel(f"accel structure ({name})", info)
                # the overlay blends onto the already display-encoded render,
                # so it must use the same gamma as the render image (ADVICE r1)
                rep.add_image(f"structure overlay ({name})",
                              np.asarray(visualize.visualize_structure(
                                  b, camera, base_image=jax.numpy.asarray(img))),
                              gamma=1.0 if args.tonemap else 2.2)
        rep.write(args.report)
        log.log_info("wrote %", args.report)
    return 0


def cmd_convert(args) -> int:
    from .scene.binmesh import convert_obj
    from .utils import log
    convert_obj(args.input, args.output, compress=not args.raw)
    log.log_info("converted % -> %", args.input, args.output)
    return 0


def cmd_bench(args) -> int:
    import subprocess
    return subprocess.call([sys.executable, "bench.py"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ba_pathtracing_fur")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene (Demo analog)")
    r.add_argument("-s", "--scene", default="cornell",
                   help="builtin (cornell|cornell_glossy|fur_patch|hair_ball) or scene.json")
    r.add_argument("-r", "--samples", type=int, default=100)  # Demo default
    r.add_argument("-W", "--width", type=int, default=1280)
    r.add_argument("-H", "--height", type=int, default=720)
    r.add_argument("-d", "--depth", type=int, default=5)
    r.add_argument("-o", "--output", default="render.png")
    r.add_argument("--engine", choices=("pt", "whitted"), default="pt")
    r.add_argument("--hair-lobes", choices=("r", "all"), default="r")
    r.add_argument("--supersamples", type=int, default=1)
    r.add_argument("--fur", default=None, help="N,V,R fur growth for json scenes")
    r.add_argument("--accel", default="median",
                   choices=("sah", "median", "morton", "grid", "none"),
                   help="accel structure (Demo/main.cpp:94-127 swap analog)")
    r.add_argument("--tonemap", action="store_true")
    r.add_argument("--report", default=None,
                   help="write an HTML render report (GUI analog)")
    r.add_argument("--ray-chunk", type=int, default=65536)
    r.add_argument("--seed", type=int, default=0)
    r.set_defaults(fn=cmd_render)

    c = sub.add_parser("convert", help="obj -> b3df (objToBinaryConverter analog)")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--raw", action="store_true", help="skip compression")
    c.set_defaults(fn=cmd_convert)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
