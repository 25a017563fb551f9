"""Stream compaction of live rays — the pt_sortHits analog.

The reference GPU pipeline compacts surviving rays between trace and shade
with an atomicAdd slot counter + writeback
(/root/reference/src/shaders/compute/Pathtracer/pt_sortHits.compute:17-39).
The wavefront equivalent is a prefix sum over the alive mask (XLA cumsum
lowers to an efficient scan) followed by one scatter: alive rays keep their
relative order in the front of the buffer, dead rays are parked behind them.
Static shapes are preserved — `n_alive` tells downstream stages how much of
the buffer is meaningful (e.g. for pool regeneration or microbatch sizing).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compaction_permutation(alive: jnp.ndarray):
    """[R] bool -> (perm [R] int32, n_alive int32).

    `perm` is a permutation of arange(R) with the indices of alive rays
    first (stable order), dead rays after. Gathering any SoA buffer with it
    compacts the wavefront; gathering with `invert_permutation(perm)`
    restores original order.
    """
    r = alive.shape[0]
    alive_i = alive.astype(jnp.int32)
    n_alive = jnp.sum(alive_i)
    front = jnp.cumsum(alive_i) - 1  # slot among alive
    back = n_alive + jnp.cumsum(1 - alive_i) - 1  # slot among dead
    slot = jnp.where(alive, front, back)
    perm = jnp.zeros((r,), jnp.int32).at[slot].set(jnp.arange(r, dtype=jnp.int32))
    return perm, n_alive


def invert_permutation(perm: jnp.ndarray) -> jnp.ndarray:
    r = perm.shape[0]
    return jnp.zeros((r,), jnp.int32).at[perm].set(jnp.arange(r, dtype=jnp.int32))


def gather_pytree(tree, perm):
    """Apply a ray permutation to every [R, ...] leaf of a SoA pytree."""
    return jax.tree.map(lambda x: x[perm], tree)
