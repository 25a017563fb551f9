"""utils: checkpoint/resume, tonemap, logging, clock."""

import jax
import numpy as np

from ba_pathtracing_fur.models.pathtracer import RenderConfig, render_image
from ba_pathtracing_fur.ops import tonemap
from ba_pathtracing_fur.scene.builtins import cornell_box
from ba_pathtracing_fur.utils import checkpoint as ckpt, clock, log


def test_checkpoint_resume_matches_straight_render(tmp_path):
    scene, camera = cornell_box(resolution=(16, 16))
    cfg = RenderConfig(depth=2, spp=4, ray_chunk=1024)
    key = jax.random.key(9)

    ref = np.asarray(render_image(scene, camera, key, cfg))

    # render 2 samples, checkpoint, reload, finish
    state = ckpt.fresh_state(camera.resolution, key)
    path = str(tmp_path / "ck.npz")
    it = ckpt.render_resumable(scene, camera, cfg, state,
                               checkpoint_path=path, checkpoint_every=2)
    for _ in range(2):
        state = next(it)
    ckpt.save_checkpoint(path, state)

    resumed = ckpt.load_checkpoint(path)
    assert int(resumed.sample_count) == 2
    for st in ckpt.render_resumable(scene, camera, cfg, resumed):
        final = st
    np.testing.assert_allclose(np.asarray(final.accum), ref, rtol=2e-5, atol=1e-6)


def test_tonemap_basic_properties():
    rs = np.random.RandomState(0)
    img = rs.rand(8, 8, 3).astype(np.float32) * 4.0
    out = np.asarray(tonemap.tonemap(img))
    assert out.shape == img.shape
    assert np.isfinite(out).all()
    # luminance is compressed into a displayable-ish range
    assert out.max() < 3.0


def test_tonemap_differentiable():
    import jax.numpy as jnp
    img = jnp.ones((4, 4, 3)) * 0.5

    def f(x):
        return jnp.sum(tonemap.tonemap(x))

    g = jax.grad(f)(img)
    assert bool(jnp.isfinite(g).all())


def test_log_percent_substitution(capsys):
    log.log_info("a % b % c", 1, "two")
    # no exception; substitution order preserved
    assert log._subst("x % y %", "A", "B") == "x A y B"


def test_clock_measures():
    c = clock.Clock()
    assert c.elapsed() >= 0.0
    dc = clock.DeviceClock()
    import jax.numpy as jnp
    v = jnp.ones((8,)).sum()
    assert dc.stop(v) >= 0.0
