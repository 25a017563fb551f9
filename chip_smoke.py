"""Smoke run of the fur path tracer on one NVIDIA GPU.

Drives the main path through the public API at the sizes users render,
checks every result against the repo's own references, and prints one JSON
line last. Every figure it prints is a smoke reading, not a benchmark.

    python chip_smoke.py              # one card: phases 1-5
    python chip_smoke.py --chips 4    # four cards: the sharded phase only

Phases of the one-card run:
  1. device check (no GPU -> exit 1, nothing printed as a result)
  2. Cornell with the level-2 fused bounce kernel (Pallas, Triton route) at
     1280x720 and the glossy MIS+RR Cornell at 512x512: one bounce field by
     field against trace_bounce, the whole image against the XLA path
  3. the 1M-fiber hair ball (9.2M cones, median BVH) at 1024x1024: render,
     and the XLA traversal's closest-hit rows / any-hit flags against the
     chunked brute force on 2,048 of the frame's rays
  4. one gradient step of diff/fit.py on the fur patch at 256x256
  5. one CLI render of the Cornell box to out/chip_smoke_cli.png

The four-card run renders the hair ball with dp=4 and with dp=2 x geo=2
against the one-card render of the same key, renders dp=4's four pixel
quarters on one card as a witness of where any difference comes from, and
takes one parallel.train_step on four cards.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: Image gates of a fused path against the unfused XLA reference: the same
#: estimator on the same RNG streams, so differences come only from float
#: decisions that land on the other side under another op order (Triton vs
#: XLA contraction) and re-route an isolated path. Mean |diff| bounds the
#: bias, the flip fraction (pixels whose max-channel |diff| > 1e-3) bounds
#: how many paths re-routed (tests/test_fused_shade.py uses the same gates).
IMG_MEAN_TOL = 5e-3
IMG_FLIP_TOL = 0.02
#: One bounce, per field: an element mismatches when |a-b| > 1e-4 + 1e-4|a|;
#: at most this fraction may (the same flips, one bounce deep).
FIELD_FLIP_TOL = 0.02
#: Sharded vs one-card image: elementwise tolerances of
#: tests/test_parallel.py:27, :78. XLA compiles the shard_map program's
#: hair-BSDF sampling with other rounding than the one-card program: one
#: bounce from the same state differs by at most 2.4e-7 in any field, with
#: bit-identical hits (benchmarks/shard_parity.py on 4 CPU devices), and a
#: later grazing hit or shadow test turns a few such rays onto another
#: path. So at most SHARD_OUTLIERS of the elements may fall outside, about
#: 3x the dp=4 reading on the card (PERF.md), and at most SHARD_ROW_OUTLIERS
#: of any image row, which a shard or seam fault would exceed.
SHARD_RTOL, SHARD_ATOL = 2e-5, 2e-6
SHARD_OUTLIERS = 1e-3
SHARD_ROW_OUTLIERS = 0.05
#: The flagship hair ball: fibers, image side, spp.
HAIR_FIBERS, HAIR_RES, HAIR_SPP = 1_000_000, 1024, 1


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`nvidia-smi` name and power limit of the cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def timed(fn, *args):
    """(result, seconds) of one call that ends in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compile_and_time(fn, *args):
    """Compile fn for args, run it once warm; returns (out, compile_s,
    run_s)."""
    import jax
    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(exe(*args))  # first run (allocations)
    out, run_s = timed(exe, *args)
    return out, compile_s, run_s


def image_gates(name: str, ref, got) -> None:
    import numpy as np
    ref, got = np.asarray(ref), np.asarray(got)
    check(bool(np.all(np.isfinite(got))), f"{name}: non-finite pixels")
    d = np.abs(ref - got)
    mean, flips = float(d.mean()), float(np.mean(d.max(-1) > 1e-3))
    log(f"  {name}: image vs XLA path mean|d|={mean:.3e} (tol "
        f"{IMG_MEAN_TOL}) flips={flips:.4f} (tol {IMG_FLIP_TOL})")
    check(mean < IMG_MEAN_TOL and flips <= IMG_FLIP_TOL,
          f"{name}: image differs from the XLA path")


def primary_state(camera, key):
    import jax.numpy as jnp
    from ba_pathtracing_fur.core import camera as cam_mod, rng
    from ba_pathtracing_fur.models import pathtracer as pt
    w, h = camera.resolution
    ids = jnp.arange(w * h)
    keys = rng.keys_for_pixels(key, ids, 0)
    jitter = rng.bounce_uniform(keys, -1, 2, tag=7)
    o, d = cam_mod.rays_from_pixels(
        camera, (ids % w).astype(jnp.float32),
        (ids // w).astype(jnp.float32), jitter)
    return pt.init_state(o, d), keys


def cornell_phase(name, res, variant, depth, spp, extra):
    """Level-2 kernel vs the XLA path on one Cornell configuration."""
    import jax
    import numpy as np
    from ba_pathtracing_fur.models import pathtracer as pt
    from ba_pathtracing_fur.ops.pallas import shade as pshade
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    scene, camera = builtins.cornell_box(resolution=res, variant=variant)
    scene = to_device(scene)
    check(pshade.use_full_kernel(jax.default_backend(), scene),
          f"{name}: level-2 kernel not selected")
    r = res[0] * res[1]
    base = dict(depth=depth, spp=spp, ray_chunk=r, compact=False, **extra)
    cfg_k = pt.RenderConfig(**base, fused_shading=True)
    cfg_x = pt.RenderConfig(**base)
    key = jax.random.key(0)

    # one bounce, field by field, from the camera wavefront and two more
    st, keys = jax.jit(primary_state)(camera, key)
    bounce_k = jax.jit(lambda s, k, b: pt.trace_bounce_fused(
        s, scene, k, b, cfg_k))
    bounce_x = jax.jit(lambda s, k, b: pt.trace_bounce(s, scene, k, b, cfg_x))
    for b in range(3):
        ref = bounce_x(st, keys, b)
        got = bounce_k(st, keys, b)
        worst = 0.0
        for f in ("origin", "direction", "radiance", "color", "flags",
                  "theta_i", "prev_pdf"):
            a = np.asarray(getattr(ref, f), np.float64)
            g = np.asarray(getattr(got, f), np.float64)
            check(bool(np.all(np.isfinite(g))), f"{name}: {f} non-finite")
            bad = float(np.mean(np.abs(a - g) > 1e-4 + 1e-4 * np.abs(a)))
            worst = max(worst, bad)
            check(bad < FIELD_FLIP_TOL,
                  f"{name}: bounce {b} field {f} {bad:.4f} mismatched")
        log(f"  {name}: bounce {b} over {r} rays, worst field mismatch "
            f"{worst:.5f} (tol {FIELD_FLIP_TOL})")
        st = ref
    _, t_bk = timed(bounce_k, st, keys, 3)
    _, t_bx = timed(bounce_x, st, keys, 3)
    log(f"  {name}: one bounce (smoke reading) kernel {t_bk * 1e3:.2f} ms, "
        f"XLA unfused {t_bx * 1e3:.2f} ms")

    render = lambda cfg: (lambda s, k: pt.render_image(s, camera, k, cfg))
    img_k, ck, rk = compile_and_time(render(cfg_k), scene, key)
    img_x, cx, rx = compile_and_time(render(cfg_x), scene, key)
    rays = r * spp * depth
    log(f"  {name}: {res[0]}x{res[1]} depth {depth} spp {spp} (smoke "
        f"reading) kernel compile {ck:.1f} s run {rk:.3f} s "
        f"{rays / rk / 1e6:.1f}M rays/s | XLA compile {cx:.1f} s run "
        f"{rx:.3f} s {rays / rx / 1e6:.1f}M rays/s")
    image_gates(name, img_x, img_k)


def hair_ball_phase(n_fibers=HAIR_FIBERS, res=HAIR_RES, spp=HAIR_SPP):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ba_pathtracing_fur.models import pathtracer as pt
    from ba_pathtracing_fur.ops import bruteforce, traverse
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    dev = jax.devices()[0]
    t0 = time.perf_counter()
    scene, camera = builtins.hair_ball(resolution=(res, res),
                                       n_fibers=n_fibers, on_device=True)
    hint = dict(builtins.LAST_HAIRBALL_GEN)
    scene = traverse.attach_bvh(scene, method="median",
                                cone_split_hint=hint)
    scene = to_device(scene)
    jax.block_until_ready(scene)
    build_s = time.perf_counter() - t0
    b = scene.cone_bvh
    check(b is not None, "hair ball: no cone BVH")
    log(f"  hair_ball: {int(scene.cones.count)} cones, "
        f"{int(scene.tris.count)} tris, leaves {b.n_leaves}x{b.leaf_size} "
        f"fanout {b.fanout}; build {build_s:.1f} s "
        f"stages {traverse.LAST_BUILD_STATS}")

    cfg = pt.RenderConfig(depth=4, spp=spp, ray_chunk=65536, compact=False,
                          fused_shading=True)
    key = jax.random.key(0)
    fn = lambda s, k: pt.render_image(s, camera, k, cfg)
    img, c_s, r_s = compile_and_time(fn, scene, key)
    img = np.asarray(img)
    rays = res * res * spp * cfg.depth
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"  hair_ball: {res}x{res} depth 4 spp {spp} (smoke reading) "
        f"compile {c_s:.1f} s render {r_s:.3f} s "
        f"{rays / r_s / 1e6:.3f}M rays/s peak_bytes_in_use {peak}")
    check(bool(np.all(np.isfinite(img))), "hair ball: non-finite pixels")
    check(float(img.max()) > 0.01 and float(img.std()) > 1e-3,
          "hair ball: blank image")

    # XLA traversal vs chunked brute force on 2,048 of the frame's rays
    st, _ = jax.jit(primary_state)(camera, key)
    idx = jnp.asarray(np.random.RandomState(0).choice(res * res, 2048,
                                                      replace=False))
    o, d = st.origin[idx], st.direction[idx]
    flat = scene.replace(tri_bvh=None, cone_bvh=None)
    bvh_hit = jax.jit(lambda s, o, d: traverse.closest_hit(
        o, d, s, chunk=1024))(scene, o, d)
    bf_hit = jax.jit(lambda s, o, d: bruteforce.closest_hit(
        o, d, s, chunk=16))(flat, o, d)
    # brute-force rows index the reordered packs; map them to prim ids
    bf_id = np.where(np.asarray(bf_hit.prim_type) == bruteforce.PRIM_CONE,
                     np.asarray(b.perm)[np.asarray(bf_hit.prim_id)],
                     np.asarray(bf_hit.prim_id))
    same_type = np.asarray(bvh_hit.prim_type) == np.asarray(bf_hit.prim_type)
    same_row = same_type & (np.asarray(bvh_hit.prim_id) == bf_id)
    n_hit = int(np.sum(np.asarray(bf_hit.valid)))
    row_mis = float(np.mean(~same_row))
    log(f"  hair_ball: closest hit on 2048 rays ({n_hit} hit): "
        f"row mismatch {row_mis:.4f}")
    check(n_hit > 100, "hair ball: sampled rays hit almost nothing")
    check(row_mis <= 0.005, "hair ball: traversal rows differ from brute "
          "force")
    # shadow rays from the hit points toward the quad light's centre
    pos = np.asarray(bf_hit.position)
    valid = np.asarray(bf_hit.valid)
    lp = np.asarray(scene.lights.position)[0]
    so = np.where(valid[:, None], pos, np.asarray(o))
    to_l = lp[None] - so
    dist = np.linalg.norm(to_l, axis=-1)
    sd = to_l / dist[:, None]
    so = so + 1e-4 * sd
    tmax = jnp.asarray(np.where(valid, dist, 0.0), jnp.float32)
    so, sd = jnp.asarray(so, jnp.float32), jnp.asarray(sd, jnp.float32)
    bvh_any = np.asarray(jax.jit(lambda s, o, d, t: traverse.any_hit(
        o, d, s, t, chunk=1024))(scene, so, sd, tmax))
    bf_any = np.asarray(jax.jit(lambda s, o, d, t: bruteforce.any_hit(
        o, d, s, t, chunk=16))(flat, so, sd, tmax))
    any_mis = float(np.mean(bvh_any != bf_any))
    log(f"  hair_ball: any hit on {int(valid.sum())} shadow rays "
        f"({int(bf_any.sum())} blocked): flag mismatch {any_mis:.4f}")
    check(any_mis <= 0.005, "hair ball: any-hit flags differ from brute "
          "force")


def gradient_phase():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ba_pathtracing_fur import diff
    from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    scene, camera = builtins.fur_patch(resolution=(256, 256))
    scene = to_device(scene)
    cfg = RenderConfig(depth=2, spp=1, ray_chunk=4096)
    key = jax.random.key(1)
    target_scene = scene.replace(materials=scene.materials.replace(
        diffuse=scene.materials.diffuse * 0.5))
    target = render_image(target_scene, camera, key, cfg)
    params = diff.make_params(scene)
    t0 = time.perf_counter()
    loss, grads = jax.jit(lambda p: jax.value_and_grad(diff.render_loss)(
        p, scene, camera, key, target, cfg))(params)
    g = np.asarray(grads["materials"]["diffuse"])
    log(f"  fur_patch grad: {int(scene.cones.count)} cones, loss "
        f"{float(loss):.4e} |grad diffuse| {float(np.abs(g).sum()):.4e} "
        f"(smoke reading: {time.perf_counter() - t0:.1f} s incl. compile)")
    check(bool(np.isfinite(float(loss))), "gradient: loss not finite")
    check(bool(np.all(np.isfinite(g))) and float(np.abs(g).sum()) > 0,
          "gradient: not finite or all zero")
    res = diff.fit(scene, camera, target, cfg, steps=1, key=key)
    check(bool(np.all(np.isfinite(res.losses))), "fit: loss not finite")
    log(f"  fit: one step, loss {float(res.losses[0]):.4e}")


def cli_phase():
    from ba_pathtracing_fur import cli
    out = os.path.join(HERE, "out", "chip_smoke_cli.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    rc = cli.main(["render", "-s", "cornell", "-W", "128", "-H", "72",
                   "-r", "4", "-d", "3", "-o", out])
    check(rc == 0 and os.path.getsize(out) > 0, "cli render failed")
    log(f"  cli: wrote {os.path.relpath(out, HERE)}")


def sharded_phase(n_fibers=HAIR_FIBERS, res=HAIR_RES):
    """dp=4 and dp=2 x geo=2 hair-ball renders vs the one-card render, and
    one train_step, on four devices."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ba_pathtracing_fur.models.pathtracer import (
        RenderConfig, render_image, render_sample_ids)
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.parallel import (
        TrainState, make_mesh, render_image_sharded, train_step)
    from ba_pathtracing_fur.parallel.render import (
        geo_closest_fn, geo_occlude_fn, shard_scene_bvh)
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device

    devs = jax.devices()
    check(len(devs) == 4, f"--chips 4 needs 4 devices, found {len(devs)}")
    scene0, camera = builtins.hair_ball(resolution=(res, res),
                                        n_fibers=n_fibers, on_device=True)
    hint = dict(builtins.LAST_HAIRBALL_GEN)
    cfg = RenderConfig(depth=4, spp=1, ray_chunk=65536, compact=False)
    key = jax.random.key(2)
    scene = to_device(traverse.attach_bvh(scene0, method="median",
                                          cone_split_hint=hint))
    ref, c_s, r_s = compile_and_time(
        lambda s, k: render_image(s, camera, k, cfg), scene, key)
    ref = np.asarray(ref)
    log(f"  one card: {res}x{res} hair ball render {r_s:.3f} s "
        f"(compile {c_s:.1f} s)")

    def compare(name, img):
        img_np = np.asarray(img)
        check(bool(np.all(np.isfinite(img_np))), f"{name}: non-finite")
        d = np.abs(img_np - ref)
        out = d > SHARD_ATOL + SHARD_RTOL * np.abs(ref)
        outside, worst_row = float(out.mean()), float(out.mean((1, 2)).max())
        log(f"  {name}: {int(np.sum(img_np != ref))} elements not bitwise "
            f"equal; max|d| {float(d.max()):.3e} mean|d| "
            f"{float(d.mean()):.3e}; outside rtol {SHARD_RTOL} atol "
            f"{SHARD_ATOL}: {outside:.6f} (tol {SHARD_OUTLIERS}), worst "
            f"row {worst_row:.6f} (tol {SHARD_ROW_OUTLIERS})")
        check(outside <= SHARD_OUTLIERS and worst_row <= SHARD_ROW_OUTLIERS
              and float(d.mean()) < IMG_MEAN_TOL,
              f"{name}: differs from the one-card render")
        return img_np

    # the four pixel quarters dp=4 gives its cards, each rendered on one
    # card by the function the shard runs: the split alone, without
    # shard_map
    quarter_fn = jax.jit(lambda s, ids: render_sample_ids(
        s, camera, ids, key, 0, cfg,
        closest_fn=geo_closest_fn(None, cfg.ray_chunk),
        occlude_fn=geo_occlude_fn(None, cfg.ray_chunk)))
    q = res * res // 4
    quarters = compare("one card, four quarters", np.concatenate([
        np.asarray(quarter_fn(scene, jnp.arange(i * q, (i + 1) * q)))
        for i in range(4)]).reshape(res, res, 3))

    mesh = make_mesh(4, geo=1)
    img, c_s, r_s = compile_and_time(
        lambda s, k: render_image_sharded(s, camera, k, cfg, mesh),
        scene, key)
    log(f"  dp=4: render {r_s:.3f} s (compile {c_s:.1f} s); sharding "
        f"{img.sharding}")
    img = compare("dp=4", img)
    log(f"  dp=4 vs the four quarters: "
        f"{int(np.sum(img != quarters))} elements not bitwise equal")

    t0 = time.perf_counter()
    gscene = shard_scene_bvh(scene0, 2)
    log(f"  geo=2 per-shard BVH build {time.perf_counter() - t0:.1f} s")
    mesh = make_mesh(4, geo=2)
    img, c_s, r_s = compile_and_time(
        lambda s, k: render_image_sharded(s, camera, k, cfg, mesh),
        gscene, key)
    log(f"  dp=2 x geo=2: render {r_s:.3f} s (compile {c_s:.1f} s); "
        f"sharding {img.sharding}")
    compare("dp=2 x geo=2", img)

    cscene, ccam = builtins.cornell_box(resolution=(64, 64))
    cscene = to_device(cscene)
    tcfg = RenderConfig(depth=2, spp=1, ray_chunk=4096)
    state = TrainState(materials=cscene.materials, step=jnp.int32(0))
    step = jax.jit(train_step, static_argnames=("cfg", "mesh", "lr"))
    _, loss = step(state, cscene, ccam, key,
                   jnp.zeros((64, 64, 3), jnp.float32), cfg=tcfg,
                   mesh=mesh, lr=0.05)
    check(bool(np.isfinite(float(loss))), "train_step: loss not finite")
    log(f"  train_step on 4 cards (dp=2 x geo=2): loss {float(loss):.4e}")
    for dv in devs:
        log(f"  {dv}: peak_bytes_in_use "
            f"{(dv.memory_stats() or {}).get('peak_bytes_in_use', 0)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import ba_pathtracing_fur  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the package is not next to this script "
              f"({e})", file=sys.stderr)
        return 1
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__} devices {devs}")
    if devs[0].platform != "gpu":
        print(f"chip_smoke: FAIL: no GPU (platform {devs[0].platform})",
              file=sys.stderr)
        return 1
    kind = devs[0].device_kind
    log(f"device_kind {kind} count {len(devs)}")
    log(f"card (nvidia-smi name, power.limit): {card_line()}")

    if args.chips == 4:
        phases = [("sharded", sharded_phase)]
    else:
        phases = [
            ("cornell", lambda: (
                cornell_phase("reference_default_720p", (1280, 720),
                              "diffuse", 5, 4, {}),
                cornell_phase("cornell_glossy_mis", (512, 512), "glossy", 4,
                              4, dict(mis=True, rr=True)))),
            ("hairball", hair_ball_phase),
            ("grad", gradient_phase),
            ("cli", cli_phase),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        try:
            fn()
        except Exception as e:  # report the phase, then fail the run
            print(f"chip_smoke: FAIL in phase {name}: {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            raise
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")

    log(f"card (nvidia-smi name, power.limit): {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
