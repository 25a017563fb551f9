"""Flagship run at BASELINE spec (config 5): 1M-fiber hair ball, 1024^2,
256 spp progressive, one differentiable step on the fur parameters.

Matches /root/repo/BASELINE.json config 5 and the reference's default fur
demo flow (Demo/main.cpp:235 addFurFibersToAllMeshes -> progressive render).
Progressive accumulation checkpoints every CHECKPOINT_EVERY samples
(utils.checkpoint), so a partial run still leaves a valid image + resumable
state — the reference's interactive render-to-PNG-anytime surface
(Demo/main.cpp:129-141) as a batch artifact.

Writes:
  out/flagship_hair_ball.png    tonemapped render
  out/FLAGSHIP.json             wall, rays/s, grad-step time, build stages
  out/flagship_ckpt.npz         progressive state (resume surface)

Env knobs: FLAGSHIP_FIBERS / FLAGSHIP_RES / FLAGSHIP_SPP / CHECKPOINT_EVERY.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main() -> None:
    from ba_pathtracing_fur.models.pathtracer import (
        RenderConfig, render_sample)
    from ba_pathtracing_fur.ops import traverse
    from ba_pathtracing_fur.scene import builtins
    from ba_pathtracing_fur.scene.types import to_device
    from ba_pathtracing_fur.utils import checkpoint as ckpt_mod, film

    fibers = int(os.environ.get("FLAGSHIP_FIBERS", "1000000"))
    res = int(os.environ.get("FLAGSHIP_RES", "1024"))
    spp = int(os.environ.get("FLAGSHIP_SPP", "256"))
    every = int(os.environ.get("CHECKPOINT_EVERY", "16"))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "out")
    os.makedirs(out_dir, exist_ok=True)
    stats: dict = {"fibers": fibers, "res": [res, res], "spp": spp,
                   "depth": 4}

    # On-device scene generation: the fiber pack is a pure jit of the
    # threefry draws, so the ~90 s host-numpy growth and the 600 MB pack
    # upload are gone; the BVH split gets host centroids recomputed from
    # the same 20 MB of draws (builtins.LAST_HAIRBALL_GEN). Set
    # FLAGSHIP_HOST_GEN=1 to compare against the legacy host path.
    host_gen = os.environ.get("FLAGSHIP_HOST_GEN") == "1"
    t0 = time.perf_counter()
    scene, camera = builtins.hair_ball(resolution=(res, res),
                                       n_fibers=fibers,
                                       on_device=not host_gen)
    hint = None if host_gen else dict(builtins.LAST_HAIRBALL_GEN)
    if scene.cones.count:
        jax.block_until_ready(scene.cones.base)
    stats["scene_gen_s"] = round(time.perf_counter() - t0, 1)

    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="median",
                                cone_split_hint=hint)
    jax.block_until_ready(scene)
    stats["bvh_build_s"] = round(time.perf_counter() - t0, 1)
    stats["bvh_build_stages"] = dict(traverse.LAST_BUILD_STATS)
    scene = to_device(scene)
    stats["n_cones"] = int(scene.cones.count)
    stats["time_to_first_ray_s"] = round(
        stats["scene_gen_s"] + stats["bvh_build_s"], 1)

    # matches bench.py's hair_ball config
    cfg = RenderConfig(depth=4, spp=spp, ray_chunk=65536, compact=False,
                       fused_shading=True)
    key = jax.random.key(0)

    # --- one differentiable step on the fur lobe parameters at full scale
    # (BASELINE config 5: "differentiable fur params"). Promotes the
    # reference's per-eval randomized alpha/beta (Bsdf.cpp:485-489) to real
    # parameters and takes one SGD step against a darker target.
    gcfg = RenderConfig(depth=2, spp=1, ray_chunk=2048, compact=False,
                        remat=True)

    def loss_fn(params, scene, key):
        mats = scene.materials.replace(**params)
        c = render_sample(scene.replace(materials=mats), camera, key, 0, gcfg)
        return jnp.mean(c)

    params = {"hair_alpha": scene.materials.hair_alpha,
              "hair_beta": scene.materials.hair_beta}
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    t0 = time.perf_counter()
    loss, grads = grad_fn(params, scene, jax.random.key(11))
    jax.block_until_ready((loss, grads))
    stats["grad_step_compile_plus_run_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    loss, grads = grad_fn(params, scene, jax.random.key(12))
    jax.block_until_ready((loss, grads))
    stats["grad_step_s"] = round(time.perf_counter() - t0, 2)
    stats["grad_loss"] = float(loss)
    stats["grad_norms"] = {k: float(jnp.linalg.norm(v))
                           for k, v in grads.items()}
    print(f"# grad step {stats['grad_step_s']}s loss={loss:.5f} "
          f"norms={stats['grad_norms']}", flush=True)

    # --- grad-step panel (VERDICT r4 task 6): forward wall vs backward
    # wall, train-step rays/s, peak HBM, and a remat on/off A/B. The
    # backward wall is grad_step - forward (same XLA program minus the
    # cotangent sweep); the A/B reruns value_and_grad WITHOUT per-bounce
    # rematerialization, which trades the extra forward evaluation for
    # storing every bounce's residuals (may OOM at full scale — recorded
    # as the A/B outcome when it does).
    def _best_of(fn, *a, reps=2):
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*a)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        return best

    dev = jax.local_devices()[0]

    def _peak_gb():
        try:
            return round(dev.memory_stats()["peak_bytes_in_use"] / 2**30, 2)
        except Exception:
            return None

    fwd_fn = jax.jit(loss_fn)
    fwd_fn(params, scene, jax.random.key(12)).block_until_ready()
    fwd_s = _best_of(fwd_fn, params, scene, jax.random.key(12))
    grad_rays = res * res * gcfg.depth  # one spp-1 sample
    panel = {
        "fwd_s": round(fwd_s, 3),
        "grad_step_s": stats["grad_step_s"],
        "bwd_s": round(stats["grad_step_s"] - fwd_s, 3),
        "train_rays_per_s": round(grad_rays / stats["grad_step_s"], 1),
        "peak_hbm_gb_remat": _peak_gb(),
    }
    gcfg_nr = gcfg._replace(remat=False)

    def loss_nr(params, scene, key):
        mats = scene.materials.replace(**params)
        c = render_sample(scene.replace(materials=mats), camera, key, 0,
                          gcfg_nr)
        return jnp.mean(c)

    try:
        grad_nr = jax.jit(jax.value_and_grad(loss_nr))
        l0, _ = grad_nr(params, scene, jax.random.key(12))
        l0.block_until_ready()
        nr_s = _best_of(grad_nr, params, scene, jax.random.key(12))
        panel["grad_step_no_remat_s"] = round(nr_s, 2)
        panel["peak_hbm_gb_no_remat"] = _peak_gb()
        panel["remat_verdict"] = (
            "remat faster" if stats["grad_step_s"] <= nr_s
            else "no-remat faster")
    except Exception as e:  # typically RESOURCE_EXHAUSTED at full scale
        panel["grad_step_no_remat_s"] = None
        panel["remat_verdict"] = f"no-remat failed: {type(e).__name__}"
    stats["grad_panel"] = panel
    print(f"# grad panel {json.dumps(panel)}", flush=True)

    # --- progressive 256-spp render with checkpointing
    r = res * res
    acc = jnp.zeros((r, 3), jnp.float32)
    sample_jit = jax.jit(render_sample, static_argnames=("cfg",))
    t_start = time.perf_counter()
    done = 0
    for i in range(spp):
        c = sample_jit(scene, camera, key, i, cfg)
        acc = acc + (c - acc) / (i + 1.0)
        done = i + 1
        if done % every == 0 or done == spp:
            jax.block_until_ready(acc)
            wall = time.perf_counter() - t_start
            img = np.asarray(acc).reshape(res, res, 3)
            film.write_png(os.path.join(out_dir, "flagship_hair_ball.png"),
                           img)
            ckpt_mod.save_checkpoint(
                os.path.join(out_dir, "flagship_ckpt.npz"),
                ckpt_mod.RenderState(
                    accum=jnp.asarray(img),
                    sample_count=jnp.int32(done),
                    key_data=jax.random.key_data(key)))
            rays = r * done * cfg.depth
            stats.update(samples_done=done,
                         render_wall_s=round(wall, 1),
                         rays_per_s=round(rays / wall, 1))
            with open(os.path.join(out_dir, "FLAGSHIP.json"), "w") as f:
                json.dump(stats, f, indent=1)
            print(f"# spp {done}/{spp}  {wall:.0f}s  "
                  f"{rays/wall/1e6:.2f}M rays/s", flush=True)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
