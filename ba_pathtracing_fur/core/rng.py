"""Counter-based per-pixel RNG.

Replaces the reference's single shared `UniformSampler` (mt19937 accessed from
every render thread — an actual data race, CPU_PathTracer.h:144, SURVEY §5)
with stateless threefry key derivation: every (pixel, sample, bounce, use)
tuple gets an independent stream, so renders are bit-reproducible and
parallelism-order independent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def keys_for_pixels(base_key: jax.Array, pixel_ids: jax.Array, sample_index) -> jax.Array:
    """One key per *global* pixel id for a progressive sample index.

    Keys depend only on (base_key, pixel_id, sample) — NOT on the position of
    the pixel within the local shard — so a multi-device render sharded over
    pixels is bit-identical to the single-device render.
    """
    k = jax.random.fold_in(base_key, sample_index)
    return jax.vmap(lambda i: jax.random.fold_in(k, i))(pixel_ids)


def pixel_keys(base_key: jax.Array, n_pixels: int, sample_index) -> jax.Array:
    """One key per pixel for a given progressive sample index. [n_pixels, 2]."""
    return keys_for_pixels(base_key, jnp.arange(n_pixels), sample_index)


def bounce_uniform(keys: jax.Array, bounce, n: int, tag: int = 0) -> jnp.ndarray:
    """[N, n] uniforms for this bounce; `tag` separates independent uses."""
    def draw(k):
        # bounce -1 is reserved for camera-jitter draws
        k = jax.random.fold_in(k, (bounce + 1) * 97 + tag)
        return jax.random.uniform(k, (n,), dtype=jnp.float32)

    return jax.vmap(draw)(keys)


def radical_inverse_vdc(bits) -> jnp.ndarray:
    """Base-2 van der Corput radical inverse: 32-bit reversal / 2^32
    (radicalInverse_VdC, inc_random.compute:34-42)."""
    u = lambda x: jnp.uint32(x)
    b = jnp.asarray(bits).astype(jnp.uint32)
    b = (b << 16) | (b >> 16)
    b = ((b & u(0x55555555)) << 1) | ((b & u(0xAAAAAAAA)) >> 1)
    b = ((b & u(0x33333333)) << 2) | ((b & u(0xCCCCCCCC)) >> 2)
    b = ((b & u(0x0F0F0F0F)) << 4) | ((b & u(0xF0F0F0F0)) >> 4)
    b = ((b & u(0x00FF00FF)) << 8) | ((b & u(0xFF00FF00)) >> 8)
    return b.astype(jnp.float32) * 2.3283064365386963e-10  # 1/2^32


def hammersley2d(i, inv_max_samples) -> jnp.ndarray:
    """Hammersley point i of the set (hammersley2d,
    inc_random.compute:44-47): (i/N, radicalInverse(i)) -> [..., 2]."""
    i = jnp.asarray(i)
    return jnp.stack([i.astype(jnp.float32) * inv_max_samples,
                      radical_inverse_vdc(i)], axis=-1)


def qmc_jitter(base_key: jax.Array, pixel_ids: jax.Array, sample_idx,
               spp: int) -> jnp.ndarray:
    """Subpixel QMC jitter [N,2]: the Hammersley point of `sample_idx`
    Cranley–Patterson-rotated by a per-pixel uniform so neighboring pixels
    are decorrelated. The wavefront use of the reference's Hammersley
    set (the GPU kernels seed it per invocation, inc_random.compute:44);
    rotation depends only on the GLOBAL pixel id so sharded renders match
    single-device bit-for-bit (like keys_for_pixels)."""
    p = hammersley2d(sample_idx, 1.0 / max(spp, 1))  # [2]
    k = jax.random.fold_in(base_key, 0x9a3)
    rot = jax.vmap(
        lambda i: jax.random.uniform(jax.random.fold_in(k, i), (2,)))(pixel_ids)
    return jnp.mod(p[None, :] + rot, 1.0)
