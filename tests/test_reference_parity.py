"""Independent reference parity: JAX renderer vs the KIRK-CPU oracle.

The oracle (`ba_pathtracing_fur.validation.kirk_cpu_oracle`) is a
double-precision numpy transliteration of the reference's CPU math written
from the C++ only — it imports NOTHING from models/ops. Both renderers are
driven with the SAME threefry uniforms (core.rng is the injection seam), so
they integrate the identical estimator and the images must agree to
float32 tolerance. This is the "img allclose vs KIRK CPU" north-star check
(BASELINE.md) that the self-referential oracles (brute force vs BVH,
Pallas vs XLA) cannot provide.
"""

import os

import jax
import numpy as np
import pytest

from ba_pathtracing_fur.core import rng
from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.scene.builtins import cornell_box
from ba_pathtracing_fur.validation import kirk_cpu_oracle as oracle

RES = (32, 32)
SPP = 8
DEPTH = 4


def _scene_to_oracle_arrays(scene):
    """Extract plain numpy DATA (not math) for the oracle."""
    tris = scene.tris
    lights = []
    for i in range(scene.lights.count):
        lights.append(dict(
            verts=np.asarray(scene.lights.verts[i], np.float64),
            color=np.asarray(scene.lights.color[i], np.float64),
            direction=np.asarray(scene.lights.direction[i], np.float64),
            const_att=float(scene.lights.const_att[i]),
            lin_att=float(scene.lights.lin_att[i]),
            quad_att=float(scene.lights.quad_att[i]),
        ))
    return dict(
        v0=np.asarray(tris.v0, np.float64),
        v1=np.asarray(tris.v1, np.float64),
        v2=np.asarray(tris.v2, np.float64),
        n0=np.asarray(tris.n0, np.float64),
        n1=np.asarray(tris.n1, np.float64),
        n2=np.asarray(tris.n2, np.float64),
        mat_id=np.asarray(tris.mat_id, np.int64),
        diffuse=np.asarray(scene.materials.diffuse, np.float64),
        emission=np.asarray(scene.materials.emission, np.float64),
        lights=lights,
        env_color=np.asarray(scene.env.color, np.float64),
        env_ambient=np.asarray(scene.env.ambient, np.float64),
    )


def _uniform_injector(base_key, n_pixels):
    """The renderer's exact RNG streams as a (sample, bounce, tag, n) ->
    [R, n] float64 callable for the oracle."""
    def uniforms(sample_idx, bounce, tag, n):
        keys = rng.keys_for_pixels(base_key, np.arange(n_pixels), sample_idx)
        return np.asarray(rng.bounce_uniform(keys, bounce, n, tag),
                          np.float64)
    return uniforms


def test_cornell_pt_allclose_vs_kirk_oracle(tmp_path):
    scene, camera = cornell_box(resolution=RES)
    key = jax.random.key(0)
    cfg = RenderConfig(depth=DEPTH, spp=SPP, ray_chunk=RES[0] * RES[1],
                       compact=False)
    ours = np.asarray(render_image(scene, camera, key, cfg), np.float64)

    cam = oracle.camera_basis(position=(0.0, 0.0, 3.4),
                              look_at=(0.0, 0.0, -1.0),
                              up=(0.0, 1.0, 0.0), resolution=RES)
    ref = oracle.render_pt(_scene_to_oracle_arrays(scene), cam,
                           _uniform_injector(key, RES[0] * RES[1]),
                           spp=SPP, depth=DEPTH)

    diff = np.abs(ours - ref)
    # f32 renderer vs f64 oracle: tiny numeric drift everywhere, isolated
    # larger differences only where a float comparison flips a discrete
    # decision (shadow-ray grazing, triangle edges)
    # measured (r5, this seed): mean ~6e-4; the diff tail is a handful of
    # DISCRETE estimator flips (grazing shadow rays / triangle edges where
    # an f32 comparison lands on the other side of the f64 one), each
    # worth O(0.1-1.0) in a single pixel-sample — their count varies a few
    # pixels with XLA fusion flags, so the gates are mean + flip fraction,
    # not a tight quantile
    assert np.mean(diff) < 1.5e-3, f"mean diff {np.mean(diff)}"
    assert np.mean(diff > 0.01) < 0.01, \
        f"flip fraction {np.mean(diff > 0.01)}"
    assert np.max(diff) < 0.5, f"max diff {np.max(diff)}"

    # golden artifacts for the report
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "out")
    if os.path.isdir(out_dir):
        from ba_pathtracing_fur.utils import film
        film.write_png(os.path.join(out_dir, "parity_cornell_ours.png"),
                       ours.astype(np.float32))
        film.write_png(os.path.join(out_dir, "parity_cornell_oracle.png"),
                       ref.astype(np.float32))


def test_oracle_is_standalone():
    """The oracle must not import anything from models/ or ops/ — its
    independence is the point."""
    import ast
    import inspect

    src = inspect.getsource(oracle)
    tree = ast.parse(src)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            assert "models" not in name and "ops" not in name, \
                f"oracle imports {name}"
            assert name in ("numpy", "__future__"), \
                f"oracle imports {name} (only numpy allowed)"
