"""Assemble out/report.html from the committed measurement artifacts.

The reference's live surface is ImGui panels over the render (SURVEY §2
row 39); the replacement is this file-based report: render gallery +
key/value panels for the pipeline A/B table, the BVH build bench, the CPU
baseline, the profiler summary, and the flagship run.

Usage:  python benchmarks/make_report.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "out")


def _load(name):
    try:
        with open(os.path.join(OUT, name)) as f:
            return json.load(f)
    except OSError:
        return None


def main() -> None:
    import numpy as np
    from PIL import Image

    from ba_pathtracing_fur.utils.report import RenderReport as Report

    rep = Report(title="ba_pathtracing_fur")

    for png, label in [("flagship_hair_ball.png", "flagship 1M-fiber ball"),
                       ("hair_ball.png", "hair ball (r2)"),
                       ("fur_patch.png", "fur patch"),
                       ("cornell.png", "cornell"),
                       ("whitted_fur.png", "whitted fur")]:
        p = os.path.join(OUT, png)
        if os.path.exists(p):
            img = np.asarray(Image.open(p), dtype=np.float32) / 255.0
            rep.add_image(label, img, gamma=1.0)

    flag = _load("FLAGSHIP.json")
    if flag:
        rep.add_panel("flagship (BASELINE config 5)", {
            k: flag[k] for k in ("fibers", "spp", "samples_done",
                                 "render_wall_s", "rays_per_s",
                                 "bvh_build_s", "bvh_build_stages",
                                 "grad_step_s", "grad_norms")
            if k in flag})

    bb = _load("BUILD_BENCH.json")
    if bb:
        rep.add_panel("BVH build @ 9M cones (stages, s)", {
            f"build{i}": b for i, b in enumerate(bb.get("builds", []))
        } | {
            f"cached{i}": b for i, b in enumerate(bb.get("cached_builds", []))
        })

    base = _load("CPU_BASELINE.json")
    if base:
        rep.add_panel("CPU baseline (measured, bench host)", {
            k: v["rays_per_s"] for k, v in base["configs"].items()})

    ab = _load("AB_PIPELINE.json")
    if ab:
        for scene, t in ab["table"].items():
            rep.add_panel(f"pipeline A/B {scene}", {
                **{k: f'{v["rays_per_s"]/1e6:.2f}M' for k, v in t["rows"].items()},
                "best": t["best"]})

    prof = _load("PROFILE_SUMMARY.json")
    if prof:
        rep.add_panel("profiler trace", {
            "wall_s": prof["wall_s"], "logdir": prof["logdir"],
            **{f'op{i}': f'{r["op"][:48]} {r["total_us"]/1e3:.1f}ms'
               for i, r in enumerate(prof.get("top_ops_by_total_us", [])[:8])}})

    path = rep.write(os.path.join(OUT, "report.html"))
    rep.write_json_sidecar(os.path.join(OUT, "report.json"))
    print(path)


if __name__ == "__main__":
    main()
