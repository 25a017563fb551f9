"""Accel-structure visualization — the DS_Visualizer analog.

The reference blends the accel structure's AABBs as colored boxes over the
render (/root/reference/src/libraries/KIRK/Utils/DS_Visualizer.{h,cpp}:
TreeVisualizer<BVH/KD>, OctreeVisualizer, UniformGridVisualizer, marked
possibly broken at DS_Visualizer.h:22). Without a GL overlay,
instead the same diagnostic is produced as images computed in one jitted
pass over the pixel rays:

  * a *visit-count heatmap* (how many node AABBs at a chosen tree level each
    primary ray enters — the quantity that actually predicts traversal cost
    on the wavefront design), and
  * a *box-edge overlay* where rays that graze an AABB near one of its edges
    are tinted, which reads like the reference's wireframe boxes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import camera as cam_mod
from .bvh import BVH


def _level_slice(bvh: BVH, level: int):
    """Heap rows of one tree level: [2^level - 1, 2^(level+1) - 1)."""
    level = max(0, min(level, bvh.depth))
    s = (1 << level) - 1
    e = (1 << (level + 1)) - 1
    return bvh.bmin[s:e], bvh.bmax[s:e]


def _ray_box_hits(o, d, bmin, bmax):
    """[R,C] slab test: t_near where hit else inf, plus the hit flag."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)
    t0 = (bmin[None] - o[:, None]) * inv_d[:, None]
    t1 = (bmax[None] - o[:, None]) * inv_d[:, None]
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tnear <= tfar) & (tfar >= 0.0)
    return jnp.where(hit, tnear, jnp.inf), hit


def _edge_proximity(p, bmin, bmax, rel=0.06):
    """How close point p (on a box surface) is to a box edge: a surface
    point sits on one face; it is near an edge when a SECOND axis is within
    `rel` of its slab bound."""
    ext = jnp.maximum(bmax - bmin, 1e-12)
    dlo = jnp.abs(p - bmin) / ext
    dhi = jnp.abs(bmax - p) / ext
    near_bound = jnp.minimum(dlo, dhi) < rel  # [..., 3]
    return jnp.sum(near_bound.astype(jnp.int32), axis=-1) >= 2


def visualize_structure(bvh: BVH, camera: cam_mod.Camera, level: int = -1,
                        base_image: jnp.ndarray | None = None,
                        tint=(1.0, 0.55, 0.1), alpha: float = 0.55):
    """[H,W,3] diagnostic image for one tree level (-1 = leaf level).

    Channels: heatmap of AABB entries per pixel ray (normalized), with box
    edges tinted `tint`; when `base_image` is given the overlay is alpha-
    blended onto it (the reference's blended-box look, DS_Visualizer.h:22-49).
    """
    if level < 0:
        level = bvh.depth
    w, h = camera.resolution
    px, py = cam_mod.pixel_grid(camera.resolution)
    o, d = cam_mod.rays_from_pixels(
        camera, px, py, jnp.full((w * h, 2), 0.5, jnp.float32),
        dof_uniforms=jnp.full((w * h, 2), 0.5, jnp.float32))
    bmin, bmax = _level_slice(bvh, level)

    tnear, hit = _ray_box_hits(o, d, bmin, bmax)
    count = hit.sum(axis=-1).astype(jnp.float32)  # [R]

    # nearest box's entry point → edge proximity for the wireframe look
    j = jnp.argmin(tnear, axis=-1)
    t = jnp.take_along_axis(tnear, j[:, None], axis=-1)[:, 0]
    any_hit = jnp.isfinite(t)
    p = o + jnp.where(any_hit, t, 0.0)[:, None] * d
    on_edge = any_hit & _edge_proximity(p, bmin[j], bmax[j])

    heat = count / jnp.maximum(count.max(), 1.0)
    img = jnp.stack([heat, heat * 0.35, 1.0 - heat], axis=-1)  # cool→hot
    img = jnp.where(on_edge[:, None], jnp.asarray(tint, jnp.float32), img)
    img = img.reshape(h, w, 3)
    if base_image is not None:
        mask = (count.reshape(h, w, 1) > 0) | on_edge.reshape(h, w, 1)
        img = jnp.where(mask, (1 - alpha) * base_image + alpha * img,
                        base_image)
    return img


def visit_count_stats(bvh: BVH, camera: cam_mod.Camera, level: int = -1):
    """(mean, max) AABB entries per primary ray at `level` — the printable
    companion (TreeAccel::printDebugInfo style) to the heatmap."""
    if level < 0:
        level = bvh.depth
    w, h = camera.resolution
    px, py = cam_mod.pixel_grid(camera.resolution)
    o, d = cam_mod.rays_from_pixels(
        camera, px, py, jnp.full((w * h, 2), 0.5, jnp.float32),
        dof_uniforms=jnp.full((w * h, 2), 0.5, jnp.float32))
    bmin, bmax = _level_slice(bvh, level)
    _, hit = _ray_box_hits(o, d, bmin, bmax)
    count = hit.sum(axis=-1)
    return float(count.mean()), int(count.max())
