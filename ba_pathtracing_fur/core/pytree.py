"""Frozen dataclasses registered as JAX pytrees.

`field(pytree_node=False)` marks a static field: it is part of the treedef
(hashed into jit's cache key, so a new value retraces) instead of a leaf.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """dataclasses.field with a static (non-leaf) switch."""
    metadata = {**kwargs.pop("metadata", {}), "static": not pytree_node}
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration + a `.replace` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
