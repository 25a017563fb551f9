"""Fused bounce-shade kernel vs the unfused wavefront (trace_bounce).

The fused path (cfg.fused_shading -> ops/pallas/shade.shade_bounce wrapping
models/shade_core) must integrate the IDENTICAL estimator: same RNG
streams, same masks, same quirks. Differences are limited to isolated
float-boundary decision flips (a comparison landing on the other side
under different op fusion), so gates are mean + flip fraction, matching
tests/test_reference_parity.py's rationale. The level-2 kernel's own tests
(interpret mode here, compiled on a GPU) are in tests/test_full_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.core import camera as cam_mod, rng
from ba_pathtracing_fur.models import pathtracer as pt
from ba_pathtracing_fur.scene import builtins


def _compare(scene, cam, cfg_kw, res, atol_mean=5e-3, flip_frac=0.02):
    key = jax.random.key(0)
    cfg = pt.RenderConfig(**cfg_kw)
    cfg_f = pt.RenderConfig(**cfg_kw, fused_shading=True)
    a = np.asarray(pt.render_image(scene, cam, key, cfg))
    b = np.asarray(pt.render_image(scene, cam, key, cfg_f))
    assert np.all(np.isfinite(b))
    d = np.abs(a - b)
    assert np.mean(d) < atol_mean, f"mean {np.mean(d)}"
    assert np.mean(d.max(-1) > 1e-3) <= flip_frac, \
        f"flips {np.mean(d.max(-1) > 1e-3)}"
    return a, b


def test_fused_cornell_diffuse():
    scene, cam = builtins.cornell_box(resolution=(16, 16))
    _compare(scene, cam, dict(depth=3, spp=2, ray_chunk=256, compact=False),
             (16, 16))


def test_fused_cornell_glossy_mis_rr():
    scene, cam = builtins.cornell_box(resolution=(16, 16), variant="glossy")
    _compare(scene, cam, dict(depth=3, spp=2, ray_chunk=256, compact=False,
                              mis=True, rr=True), (16, 16))


def test_fused_fur_patch_hair():
    scene, cam = builtins.fur_patch(resolution=(16, 16), fibers_per_face=6,
                                    fiber_verts=5)
    _compare(scene, cam, dict(depth=3, spp=2, ray_chunk=256, compact=False),
             (16, 16))


def test_fused_with_compaction():
    scene, cam = builtins.cornell_box(resolution=(16, 16))
    _compare(scene, cam, dict(depth=3, spp=2, ray_chunk=256, compact=True),
             (16, 16))


def test_fused_single_bounce_exact():
    """From a clean wavefront, one fused bounce (the XLA shade stage)
    reproduces trace_bounce field-for-field at f32 tolerance."""
    scene, cam = builtins.fur_patch(resolution=(12, 12), fibers_per_face=4,
                                    fiber_verts=4)
    key = jax.random.key(3)
    r = 144
    pixel_ids = jnp.arange(r)
    keys = rng.keys_for_pixels(key, pixel_ids, 0)
    jitter = rng.bounce_uniform(keys, -1, 2, tag=7)
    px = (pixel_ids % 12).astype(jnp.float32)
    py = (pixel_ids // 12).astype(jnp.float32)
    o, d = cam_mod.rays_from_pixels(cam, px, py, jitter)
    st = pt.init_state(o, d)
    cfg = pt.RenderConfig(depth=2, spp=1, ray_chunk=256, compact=False)
    for bounce in range(3):
        ref = pt.trace_bounce(st, scene, keys, bounce, cfg)
        got = pt.trace_bounce_fused(st, scene, keys, bounce, cfg)
        for f in ("origin", "direction", "radiance", "color", "flags",
                  "theta_i", "prev_pdf"):
            a = np.asarray(getattr(ref, f), np.float64)
            b = np.asarray(getattr(got, f), np.float64)
            bad = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(a)
            assert bad.mean() < 0.02, \
                f"bounce {bounce} field {f}: {bad.mean():.4f} mismatched"
        st = ref
