"""Level-2 fused bounce kernel (ops/pallas/shade.shade_bounce_full).

Here the kernel runs in the Pallas interpreter, which executes the same
kernel body the GPU compiles through Triton; the `gpu`-marked cases run it
compiled and skip on hosts without a GPU. Gates as in
tests/test_fused_shade.py: same estimator, same RNG streams, so only
isolated float-boundary decision flips may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ba_pathtracing_fur.core import camera as cam_mod, rng
from ba_pathtracing_fur.models import pathtracer as pt
from ba_pathtracing_fur.models.shade_core import CoreCfg
from ba_pathtracing_fur.ops import bruteforce, intersect as isect
from ba_pathtracing_fur.ops.pallas import shade as pshade
from ba_pathtracing_fur.scene import builtins
from ba_pathtracing_fur.scene.types import to_device

FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i",
          "prev_pdf")


def _compare_images(scene, cam, cfg_kw, **kernel_kw):
    key = jax.random.key(0)
    a = np.asarray(pt.render_image(scene, cam, key, pt.RenderConfig(**cfg_kw)))
    b = np.asarray(pt.render_image(scene, cam, key, pt.RenderConfig(
        **cfg_kw, fused_shading=True, **kernel_kw)))
    assert np.all(np.isfinite(b))
    d = np.abs(a - b)
    assert np.mean(d) < 5e-3, f"mean {np.mean(d)}"
    assert np.mean(d.max(-1) > 1e-3) <= 0.02, \
        f"flips {np.mean(d.max(-1) > 1e-3)}"


def _camera_wavefront(cam, key, w, h):
    ids = jnp.arange(w * h)
    keys = rng.keys_for_pixels(key, ids, 0)
    jitter = rng.bounce_uniform(keys, -1, 2, tag=7)
    o, d = cam_mod.rays_from_pixels(cam, (ids % w).astype(jnp.float32),
                                    (ids // w).astype(jnp.float32), jitter)
    return pt.init_state(o, d), keys


def _assert_fields_close(ref, got, what):
    for f in FIELDS:
        a = np.asarray(getattr(ref, f), np.float64)
        b = np.asarray(getattr(got, f), np.float64)
        assert a.shape == b.shape, f"{what} {f}: shape {b.shape}"
        bad = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(a)
        assert bad.mean() < 0.02, f"{what} {f}: {bad.mean():.4f} mismatched"


def test_interpret_cornell_diffuse():
    scene, cam = builtins.cornell_box(resolution=(16, 16))
    _compare_images(scene, cam, dict(depth=3, spp=2, ray_chunk=256,
                                     compact=False), interpret=True)


def test_interpret_cornell_glossy_mis_rr():
    scene, cam = builtins.cornell_box(resolution=(16, 16), variant="glossy")
    _compare_images(scene, cam, dict(depth=3, spp=2, ray_chunk=256,
                                     compact=False, mis=True, rr=True),
                    interpret=True)


def test_interpret_ragged_ray_count():
    """R = 15*13 = 195 is not a multiple of the 128-ray block: the padded
    tail lanes must not leak into the live rows."""
    scene, cam = builtins.cornell_box(resolution=(15, 13))
    st, keys = _camera_wavefront(cam, jax.random.key(4), 15, 13)
    cfg = pt.RenderConfig(depth=3, spp=1, ray_chunk=256, compact=False)
    cfg_k = pt.RenderConfig(depth=3, spp=1, ray_chunk=256, compact=False,
                            fused_shading=True, interpret=True)
    for bounce in range(3):
        ref = pt.trace_bounce(st, scene, keys, bounce, cfg)
        got = pt.trace_bounce_fused(st, scene, keys, bounce, cfg_k)
        _assert_fields_close(ref, got, f"bounce {bounce}")
        st = ref


def test_pad_pow2_shapes():
    scene, _ = builtins.cornell_box(resolution=(8, 8))
    scene = to_device(scene)
    tris = pshade.pack_tris_table(scene.tris)
    mats = pshade.pack_mats_table(scene.materials)
    lights = pshade.pack_lights_table(scene.lights)
    assert tris.shape == (int(scene.tris.count), 19)
    assert mats.shape[1] == 20 and lights.shape[1] == 29
    for t in (tris, mats, lights):
        p = pshade.pad_pow2(t)
        r, c = p.shape
        assert r & (r - 1) == 0 and c & (c - 1) == 0
        assert r >= t.shape[0] and c >= t.shape[1]
        np.testing.assert_array_equal(np.asarray(p[:t.shape[0], :t.shape[1]]),
                                      np.asarray(t))
        assert not np.any(np.asarray(p[t.shape[0]:])) and \
            not np.any(np.asarray(p[:, t.shape[1]:]))
    assert pshade.pad_pow2(jnp.zeros((0, 29))).shape == (1, 32)


def test_interpret_extra_table_padding_is_inert():
    """Zero rows past n_tris and zero columns past the fields change
    nothing: the kernel loops over n_tris only and reads named columns."""
    scene, cam = builtins.cornell_box(resolution=(8, 8))
    scene = to_device(scene)
    st, keys = _camera_wavefront(cam, jax.random.key(1), 8, 8)
    r = 64
    u = lambda n, tag: rng.bounce_uniform(keys, 0, n, tag=tag)
    kw = dict(
        origin=st.origin, direction=st.direction, radiance=st.radiance,
        color=st.color, flags=st.flags, theta_i=st.theta_i,
        prev_pdf=st.prev_pdf, env_color3=scene.env.color,
        env_ambient=scene.env.ambient, n_lights=scene.lights.count,
        n_tris=int(scene.tris.count), u_bsdf=u(2, 0), u_pick=u(1, 1)[:, 0],
        u_light=u(2, 2), u_hairp=u(1, 3)[:, 0], u_rr=jnp.zeros((r,)),
        rr_gate=jnp.zeros((r,)),
        cfg=CoreCfg(n_lights=scene.lights.count,
                    bsdfs_present=scene.bsdfs_present),
        interpret=True, block=32, num_warps=1)
    tabs = dict(mats_table=pshade.pack_mats_table(scene.materials),
                tris_table=pshade.pack_tris_table(scene.tris),
                lights_table=pshade.pack_lights_table(scene.lights))
    a = pshade.shade_bounce_full(**kw, **tabs)
    big = {k: jnp.pad(v, ((0, 100), (0, 40))) for k, v in tabs.items()}
    b = pshade.shade_bounce_full(**kw, **big)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("platform,scene_name,overridden,interp,expect", [
    ("gpu", "cornell", False, False, True),    # compiled level-2 kernel
    ("cpu", "cornell", False, False, False),   # no GPU: XLA shade stage
    ("cpu", "cornell", False, True, True),     # explicit interpreter
    ("gpu", "fur_patch", False, False, False), # cones/hair: not eligible
    ("gpu", "cornell", True, False, False),    # caller owns traversal
])
def test_kernel_choice_policy(platform, scene_name, overridden, interp,
                              expect):
    scene, _ = (builtins.cornell_box(resolution=(8, 8))
                if scene_name == "cornell" else
                builtins.fur_patch(resolution=(8, 8), fibers_per_face=2,
                                   fiber_verts=3))
    assert pshade.use_full_kernel(platform, scene, overridden=overridden,
                                  force_interpret=interp) is expect


@pytest.mark.parametrize("kind", ["tri", "cone"])
def test_chunked_side_pack_matches_grid(kind):
    """bruteforce.pack_closest / pack_any (the BVH-less side pack beside a
    BVH'd one) over several chunks == one dense grid over all rays."""
    scene, cam = builtins.hair_ball(resolution=(12, 10), n_fibers=40,
                                    fiber_verts=4)
    scene = to_device(scene)
    pack = scene.tris if kind == "tri" else scene.cones
    grid = isect.triangle_hit_grid if kind == "tri" else isect.cone_hit_grid
    st, _ = _camera_wavefront(cam, jax.random.key(2), 12, 10)
    o, d = st.origin, st.direction
    r = o.shape[0]
    t_max = jnp.full((r,), 1e30).at[::3].set(2.0)
    g = grid(o, d, pack, 1e-4, t_max[:, None])
    t_ref = jnp.min(g[0], axis=-1)
    row_ref = jnp.argmin(g[0], axis=-1)
    any_ref = jnp.any(g[-1], axis=-1)
    t, row = bruteforce.pack_closest(o, d, pack, 1e-4, t_max, chunk=32)
    hit = np.asarray(t_ref) < 1e30
    assert hit.any()
    # same math in another XLA program: contraction differences, which the
    # cone quadratic's f32 root amplifies to ~1e-5 relative
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(row)[hit],
                                  np.asarray(row_ref)[hit])
    blocked = bruteforce.pack_any(o, d, pack, 1e-4, t_max, chunk=32)
    np.testing.assert_array_equal(np.asarray(blocked), np.asarray(any_ref))


@pytest.mark.gpu
def test_gpu_kernel_matches_xla_bounce():
    """Compiled (Triton) level-2 kernel vs trace_bounce, one bounce."""
    scene, cam = builtins.cornell_box(resolution=(64, 48), variant="glossy")
    st, keys = _camera_wavefront(cam, jax.random.key(0), 64, 48)
    kw = dict(depth=3, spp=1, ray_chunk=4096, compact=False, mis=True,
              rr=True)
    got = jax.jit(lambda s, k: pt.trace_bounce_fused(
        s, scene, k, 0, pt.RenderConfig(**kw, fused_shading=True)))(st, keys)
    ref = pt.trace_bounce(st, scene, keys, 0, pt.RenderConfig(**kw))
    _assert_fields_close(ref, got, "gpu bounce 0")


@pytest.mark.gpu
def test_gpu_kernel_image_matches_xla():
    scene, cam = builtins.cornell_box(resolution=(64, 64))
    _compare_images(scene, cam, dict(depth=4, spp=2, ray_chunk=4096,
                                     compact=False))
