"""Whitted raytracer: smoke + semantics (the reference's validation-quality
path, SimpleCPURaytracer)."""

import jax
import jax.numpy as jnp
import numpy as np

from ba_pathtracing_fur.models import whitted
from ba_pathtracing_fur.scene.builtins import cornell_box, fur_patch


def test_whitted_cornell_smoke():
    scene, camera = cornell_box(resolution=(32, 32))
    cfg = whitted.WhittedConfig(depth=2, ray_chunk=4096)
    img = whitted.render_whitted(scene, camera, cfg)
    a = np.asarray(img)
    assert a.shape == (32, 32, 3)
    assert np.all(np.isfinite(a))
    assert a.max() > 0.01
    assert a.std() > 1e-3  # not a flat image


def test_whitted_deterministic():
    scene, camera = cornell_box(resolution=(16, 16))
    cfg = whitted.WhittedConfig(depth=2, ray_chunk=1024)
    a = np.asarray(whitted.render_whitted(scene, camera, cfg))
    b = np.asarray(whitted.render_whitted(scene, camera, cfg))
    np.testing.assert_array_equal(a, b)


def test_whitted_shadows_darken():
    scene, camera = cornell_box(resolution=(16, 16))
    lit = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=0, shadows=False, ray_chunk=1024)))
    shad = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=0, shadows=True, ray_chunk=1024)))
    assert shad.mean() <= lit.mean() + 1e-6


def test_whitted_fur_lobes():
    scene, camera = fur_patch(resolution=(24, 24), fibers_per_face=6,
                              fiber_verts=5, fiber_radius=0.02)
    r_only = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=1, hair_lobes="r", ray_chunk=1024)))
    all_lobes = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=1, hair_lobes="all", ray_chunk=1024)))
    assert np.all(np.isfinite(r_only)) and np.all(np.isfinite(all_lobes))
    # TT+TRT only ever add energy
    assert all_lobes.sum() >= r_only.sum() - 1e-4


def test_whitted_supersampling_smooths():
    scene, camera = cornell_box(resolution=(16, 16))
    a = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=1, supersamples=1, ray_chunk=1024)))
    b = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=1, supersamples=2, ray_chunk=1024)))
    assert np.all(np.isfinite(b))
    assert abs(a.mean() - b.mean()) < 0.2  # same scene, similar exposure


def test_whitted_adaptive_refines_edges():
    """Adaptive supersampling (adaptiveSampling,
    Simple_CPU_Raytracer.cpp:275-341): high-contrast pixels get subdivided
    corner samples, flat pixels keep the 4-corner average. A threshold of 0
    must refine everywhere; an infinite threshold reduces to the plain
    corner average."""
    scene, camera = cornell_box(resolution=(16, 16))
    base = whitted.WhittedConfig(depth=1, ray_chunk=1024)
    never = np.asarray(whitted.render_whitted(
        scene, camera, base._replace(adaptive=True, adaptive_threshold=1e9,
                                     adaptive_depth=1)))
    always = np.asarray(whitted.render_whitted(
        scene, camera, base._replace(adaptive=True, adaptive_threshold=0.0,
                                     adaptive_depth=1)))
    # depth 1 (not the depth-2 default): each extra level is 5*4^d more
    # compiled midpoint wavefronts — depth 1 already exercises the
    # refine/compact/recurse machinery and keeps this test ~4x cheaper
    default = np.asarray(whitted.render_whitted(
        scene, camera, base._replace(adaptive=True, adaptive_depth=1)))
    assert np.all(np.isfinite(always)) and np.all(np.isfinite(default))
    # refinement changes at least the silhouette/contrast pixels...
    assert np.any(np.abs(always - never) > 1e-4)
    # ...but keeps overall exposure (same scene)
    assert abs(always.mean() - never.mean()) < 0.2
    # supersamples>1 takes precedence over adaptive (renderPixel :30-38)
    ss = np.asarray(whitted.render_whitted(
        scene, camera, base._replace(adaptive=True, supersamples=2)))
    ss_ref = np.asarray(whitted.render_whitted(
        scene, camera, base._replace(supersamples=2)))
    np.testing.assert_array_equal(ss, ss_ref)


def test_record_hair_paths():
    scene, camera = fur_patch(resolution=(8, 8), fibers_per_face=8,
                              fiber_verts=5, fiber_radius=0.03)
    from ba_pathtracing_fur.core import camera as cam_mod
    px, py = cam_mod.pixel_grid(camera.resolution)
    jit = jnp.full((px.shape[0], 2), 0.5)
    o, d = cam_mod.rays_from_pixels(camera, px, py, jit)
    rec = whitted.record_hair_paths(scene, o, d)
    assert bool(rec.valid.any())
    v = np.asarray(rec.valid)
    for seg in (rec.in_ray, rec.normal0, rec.out_r, rec.out_tt, rec.out_trt):
        assert np.all(np.isfinite(np.asarray(seg)[v]))


def test_whitted_depth8_reference_default():
    """Reference default depth 8 (CPU_Raytracer.h:75) renders in one call —
    the DFS queue makes it ~tree-sized, not 2^8 wavefronts (VERDICT r1
    weak #4 done-criterion)."""
    scene, camera = cornell_box(resolution=(24, 24), variant="glossy")
    # make every surface reflective so the recursion tree actually reaches
    # depth 8 (mirror-room): reflections spawn at each level
    import jax.numpy as jnp
    scene = scene.replace(materials=scene.materials.replace(
        reflectivity=jnp.full_like(scene.materials.reflectivity, 0.8)))
    cfg = whitted.WhittedConfig(depth=8, ray_chunk=1024)
    img = np.asarray(whitted.render_whitted(scene, camera, cfg))
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01
    # deeper recursion can only add (weighted, positive) contributions on
    # specular paths; a depth-8 render differs from depth-1
    shallow = np.asarray(whitted.render_whitted(
        scene, camera, whitted.WhittedConfig(depth=1, ray_chunk=1024)))
    assert np.abs(img - shallow).max() > 1e-5


def test_whitted_dof():
    """RTFLAG_USE_DOF analog: thin-lens blur via averaged lens samples
    (depthOfField, Simple_CPU_Raytracer.cpp:236-248)."""
    import jax.numpy as jnp
    scene, camera = cornell_box(resolution=(24, 24))
    camera = camera.replace(use_dof=True, aperture=jnp.float32(0.2),
                            focus_distance=jnp.float32(2.0))
    sharp = np.asarray(whitted.render_whitted(
        scene, camera.replace(use_dof=False),
        whitted.WhittedConfig(depth=1, ray_chunk=1024)))
    blurred = np.asarray(whitted.render_whitted(
        scene, camera,
        whitted.WhittedConfig(depth=1, dof=True, dof_samples=4,
                              ray_chunk=1024)))
    assert np.all(np.isfinite(blurred))
    # defocus spreads edges: the blurred image has lower gradient energy
    def grad_energy(a):
        return float(np.abs(np.diff(a, axis=0)).sum()
                     + np.abs(np.diff(a, axis=1)).sum())
    assert grad_energy(blurred) < grad_energy(sharp)
    assert np.abs(blurred - sharp).max() > 1e-4


def test_light_shading_gated_compacted_wavefront_shadows():
    """ADVICE r3 (high): light_shading used t_max=1 for ALL lanes, so
    any_hit's octant sort (keyed dead-last by t_max <= 0) scattered live
    shadow rays past the n_alive chunk gate on compacted wavefronts larger
    than ray_chunk — silently unblocked shadows. Live lanes here sit above
    the cornell ceiling aiming down at the light (octant 7 — sorts LAST),
    dead lanes aim octant 0 (sorts first): with the bug, every live shadow
    ray lands in a gated-off chunk and reports unshadowed."""
    from ba_pathtracing_fur.models import bsdf as bsdf_mod
    from ba_pathtracing_fur.ops import traverse

    scene, _ = cornell_box(resolution=(8, 8))
    acc = traverse.attach_bvh(scene, min_prims=1)
    R, chunk, n_live = 2048, 256, 512
    light = np.array([0.0, 0.98, 0.0], np.float32)

    pos = np.tile(light + np.array([-1.5, -1.48, -1.5], np.float32), (R, 1))
    pos[:n_live] = light + np.array([0.3, 1.0, 0.3], np.float32)  # above roof
    norm = light[None] - pos
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    view = -norm
    pos_j, norm_j, view_j = map(jnp.asarray, (pos, norm, view))
    uv = jnp.zeros((R, 2), jnp.float32)
    mp = bsdf_mod.gather_materials(acc.materials,
                                   jnp.zeros((R,), jnp.int32), uv,
                                   acc.textures, acc.tex_slots)
    cfg = whitted.WhittedConfig(shadows=True, ray_chunk=chunk)
    live = jnp.arange(R) < n_live

    got = np.asarray(whitted.light_shading(
        acc, pos_j, norm_j, uv, view_j, mp, mp.diffuse, cfg,
        n_alive=jnp.int32(n_live), active=live))
    # ungated small-wavefront reference on the live lanes only
    sl = slice(0, n_live)
    ref = np.asarray(whitted.light_shading(
        acc, pos_j[sl], norm_j[sl], uv[sl], view_j[sl],
        jax.tree.map(lambda x: x[sl] if hasattr(x, "shape") and x.ndim
                     else x, mp), mp.diffuse[sl], cfg))
    np.testing.assert_allclose(got[:n_live], ref, rtol=1e-5, atol=1e-6)
    # the ceiling occludes every live lane: shadowed color is ambient-only 0
    assert np.abs(got[:n_live]).max() < 1e-6

    # control: the same gated call with unoccluded live lanes lights up
    pos2 = pos.copy()
    pos2[:n_live] = light + np.array([0.05, -0.3, 0.05], np.float32)
    norm2 = light[None] - pos2
    norm2 /= np.linalg.norm(norm2, axis=-1, keepdims=True)
    lit = np.asarray(whitted.light_shading(
        acc, jnp.asarray(pos2), jnp.asarray(norm2), uv,
        jnp.asarray(-norm2), mp, mp.diffuse, cfg,
        n_alive=jnp.int32(n_live), active=live))
    assert lit[:n_live].max() > 1e-3
