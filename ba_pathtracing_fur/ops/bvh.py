"""LBVH: on-device linear BVH build + lock-step wavefront traversal.

Wavefront replacement for the reference's pointer-based binned-SAH BVH
(/root/reference/src/libraries/KIRK/CPU/CPU_Datastructures/CPU_BVH.cpp) and
the GPU pair bvh_constructSAH/bvh_traverse.compute (SURVEY §2.3 #53-54),
which the survey calls the better model than the CPU recursion. Design:

  * BUILD: every builder targets the same *implicit complete binary tree*
    over fixed-size leaf clusters with heap indexing (children of i are
    2i+1/2i+2), AABBs reduced level-by-level with static-shape reshapes —
    no pointers, no recursion. The at-scale path (1M-fiber scenes) is the
    HYBRID build: centroid-median split in native C++ (nth_element,
    native/bvh_builder.cpp) + AABB-heap/reorder/pack as one jit on device
    (traverse._attach_one_device) — measured the only combination whose
    cluster quality (sah_cost ~194 at 100k tris) AND build time scale.
    The fully on-device morton `build` here is jit-able for dynamic
    geometry but clusters ~5x worse (sah_cost 915 vs ~194 at 100k tris)
    and its eager-build time does NOT scale — it is the small-scene /
    in-jit option, not the flagship path.

  * TRAVERSAL: all rays advance in lock-step through a `lax.while_loop`;
    each ray keeps a current node + a fixed-depth stack ([R, MAX_DEPTH]
    int32). Inner nodes: slab-test both children with `t_near < best_t`
    pruning (BoundingVolume::intersects semantics, BoundingBox.h:139-160),
    descend the nearer child and push the farther (ordered near-to-far like
    BVHNode::traverse, CPU_BVH.cpp:148-199). Leaf nodes: intersect the
    cluster's primitives (contiguous rows of the morton-reordered pack —
    one dense gather). Everything is masked vector compute over the whole
    wavefront; there is no divergence stall beyond the longest ray's visit
    count.

Empty/padded leaves carry inverted boxes (bmin=+BIG, bmax=-BIG) that never
pass the slab test; padded primitive rows are degenerate and never hit.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pytree, vecmath as vm
from ..scene.types import ConePack, TrianglePack
from . import intersect as isect

INF = isect.INF
# python float, NOT jnp.float32: the host-side builders reference BIG in
# tight numpy loops, and converting a committed jax scalar costs a device
# sync per use. jnp expressions weak-type it to f32 unchanged.
BIG = 3.0e37

#: Rounds each ray gets in traversal pass 1 before the survivor compaction
#: (multi-chunk wavefronts only). Most rays finish well inside this budget
#: (measured: primary fur rays ~4 mean / ~16 max cluster visits); the
#: divergent tail is compacted and finished densely in pass 2.
PASS1_ROUNDS = 12


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

def _expand_bits_10(v):
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(points, lo, hi):
    """30-bit 3D morton codes for points normalized into [lo, hi]. [N]."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((points - lo) / extent, 0.0, 1.0 - 1e-7)
    xyz = (q * 1024.0).astype(jnp.uint32)
    return (
        (_expand_bits_10(xyz[:, 0]) << 2)
        | (_expand_bits_10(xyz[:, 1]) << 1)
        | _expand_bits_10(xyz[:, 2])
    )


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

@pytree.dataclass
class BVH:
    """Implicit complete binary tree over morton-ordered leaf clusters.

    Heap layout: node 0 is the root, children of i are 2i+1 / 2i+2; the
    n_leaves leaf nodes occupy heap indices [n_leaves-1, 2*n_leaves-1);
    leaf j owns primitive rows [j*leaf_size, (j+1)*leaf_size) of the
    reordered pack. `perm` maps reordered row -> original primitive id
    (-1 on padding rows).

    `packed` is the traversal-time geometry: one [n_leaves, W, leaf_size]
    f32 tensor, component-major within each cluster, so a traversal round is
    ONE contiguous row gather per ray and every subsequent op is a fully
    dense [R, leaf_size] 2D tensor (not an [R,K,3] layout with a 3-wide
    innermost axis).
    """

    bmin: jnp.ndarray  # [2*n_leaves-1, 3]
    bmax: jnp.ndarray  # [2*n_leaves-1, 3]
    perm: jnp.ndarray  # [n_leaves * leaf_size] int32
    packed: jnp.ndarray | None  # [n_leaves, W, leaf_size] f32
    n_leaves: int = pytree.field(pytree_node=False)  # power of two
    leaf_size: int = pytree.field(pytree_node=False)
    # Hierarchical traversal fan-out: leaf clusters per super-cluster
    # (power of two dividing n_leaves). 0 = flat single-level traversal.
    # Super-cluster AABBs are the heap level at depth log2(n_leaves/fanout)
    # — already present in bmin/bmax, no extra storage.
    fanout: int = pytree.field(pytree_node=False, default=0)
    # True when the arrays carry a leading [n_geo] stack axis of per-shard
    # BVHs (parallel.render.shard_scene_bvh) — sharded over the "geo" mesh
    # axis and squeezed inside the shard before traversal.
    geo_stacked: bool = pytree.field(pytree_node=False, default=False)
    # Attach-time AoS of the reordered pack ([N,19] cones / [N,34] tris)
    # for the winner-row gather (traverse.take_*_rows): building it
    # in-graph per bounce is a ~700 MB HBM transient at 9.4M cones (it
    # OOM'd the flagship compile). Geometry packs are constants in every
    # supported grad path (diff.fit optimizes materials/lights/env only),
    # so a static copy loses no gradients.
    aos_rows: jnp.ndarray | None = None

    @property
    def depth(self) -> int:
        return self.n_leaves.bit_length() - 1  # log2(n_leaves)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def build(prim_bmin, prim_bmax, leaf_size: int = 8) -> BVH:
    """Build the LBVH from primitive AABBs ([N,3] each). jit-friendly:
    all shapes derive from the static N and leaf_size."""
    prim_bmin = jnp.asarray(prim_bmin)
    prim_bmax = jnp.asarray(prim_bmax)
    n = prim_bmin.shape[0]
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    n_slots = n_leaves * leaf_size

    centroids = 0.5 * (prim_bmin + prim_bmax)
    scene_lo = jnp.min(prim_bmin, axis=0)
    scene_hi = jnp.max(prim_bmax, axis=0)
    codes = morton_codes(centroids, scene_lo, scene_hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    perm = jnp.full((n_slots,), -1, jnp.int32).at[:n].set(order)
    # explicit f32: with jax_enable_x64 a python-float fill would make f64
    # pad boxes and promote every concatenated node array (ADVICE r2)
    pad_min = jnp.full((n_slots, 3), BIG, jnp.float32)
    pad_max = jnp.full((n_slots, 3), -BIG, jnp.float32)
    sbmin = pad_min.at[:n].set(prim_bmin[order])
    sbmax = pad_max.at[:n].set(prim_bmax[order])

    # leaf AABBs: reduce each cluster of leaf_size rows
    lmin = sbmin.reshape(n_leaves, leaf_size, 3).min(axis=1)
    lmax = sbmax.reshape(n_leaves, leaf_size, 3).max(axis=1)

    # levels bottom-up; heap-order concatenation (root level last -> first)
    levels_min = [lmin]
    levels_max = [lmax]
    while levels_min[0].shape[0] > 1:
        cur_min, cur_max = levels_min[0], levels_max[0]
        up_min = cur_min.reshape(-1, 2, 3).min(axis=1)
        up_max = cur_max.reshape(-1, 2, 3).max(axis=1)
        levels_min.insert(0, up_min)
        levels_max.insert(0, up_max)

    bmin = jnp.concatenate(levels_min, axis=0)
    bmax = jnp.concatenate(levels_max, axis=0)
    return BVH(bmin=bmin, bmax=bmax, perm=perm, packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


def _xp(x):
    """numpy for host arrays, jnp for device arrays/tracers — the pack and
    reorder helpers run in both worlds (host scene build vs on-device morton
    rebuild for dynamic geometry)."""
    return np if isinstance(x, np.ndarray) else jnp


def _pack_comps(comps, n_leaves, k, xp):
    """[C, W, K] component-major layout from W [N]-arrays. numpy: direct
    per-component writes (one pass; the old stack+transpose churned 3x the
    bytes — 5 s at 9M cones); jnp: stack+transpose (XLA fuses it anyway)."""
    w = len(comps)
    if xp is np:
        out = np.empty((n_leaves, w, k), np.float32)
        for i, c in enumerate(comps):
            out[:, i, :] = c.reshape(n_leaves, k)
        return out
    packed = jnp.stack(comps, axis=1).reshape(n_leaves, k, w)
    return jnp.transpose(packed, (0, 2, 1))


def pack_tris(tris: TrianglePack, bvh: BVH) -> BVH:
    """Pack the (already reordered) triangle pack for traversal:
    [C, 9, K] = (v0, e1, e2) per component, component-major."""
    xp = _xp(tris.v0)
    k = bvh.leaf_size
    v0 = tris.v0
    e1 = tris.v1 - v0
    e2 = tris.v2 - v0
    comps = [v0[:, 0], v0[:, 1], v0[:, 2],
             e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2]]
    return bvh.replace(packed=_pack_comps(comps, bvh.n_leaves, k, xp))


def pack_cones(cones: ConePack, bvh: BVH) -> BVH:
    """Pack the (already reordered) cone pack for traversal:
    [C, 16, K] = (base, u, v, w per component, slope, r_base, min_d, max_d).
    (A 13-wide layout reconstructing w = u x v in-kernel saves ~19% gather
    traffic but is NOT bit-identical to the oracle's stored w under FMA
    contraction, flipping near-tangent winners — rejected.)"""
    xp = _xp(cones.base)
    k = bvh.leaf_size
    comps = [cones.base[:, 0], cones.base[:, 1], cones.base[:, 2],
             cones.u[:, 0], cones.u[:, 1], cones.u[:, 2],
             cones.v[:, 0], cones.v[:, 1], cones.v[:, 2],
             cones.w[:, 0], cones.w[:, 1], cones.w[:, 2],
             cones.slope, cones.r_base, cones.min_d, cones.max_d]
    return bvh.replace(packed=_pack_comps(comps, bvh.n_leaves, k, xp))


def _ranges_to_perm(order, bounds, n_leaves, leaf_size):
    """Scatter per-leaf index ranges into padded leaf slots, loop-free:
    row i of `order` goes to slot leaf*leaf_size + (i - leaf_start)."""
    order = np.asarray(order, np.int64)
    bounds = np.asarray(bounds, np.int64)
    counts = np.diff(bounds)
    if counts.max(initial=0) > leaf_size:
        raise AssertionError("median split produced oversized leaf")
    from .. import native
    perm = native.ranges_to_perm(order, bounds, n_leaves, leaf_size)
    if perm is not None:  # threaded C++ pass (1.4-4.6 s -> ~0.2 s at 9M)
        return perm
    n = order.shape[0]
    leaf_of = np.repeat(np.arange(n_leaves, dtype=np.int64), counts)
    within = np.arange(n, dtype=np.int64) - bounds[leaf_of]
    perm = np.full((n_leaves * leaf_size,), -1, np.int64)
    perm[leaf_of * leaf_size + within] = order
    return perm


def build_median(prim_bmin, prim_bmax, leaf_size: int = 256) -> BVH:
    """Host-side median-split build: recursively split prim ranges at the
    centroid median of the longest axis — the same partition family as
    KIRK's SAH split (CPU_BVH.cpp:357-461) with the median as the plane.

    Produces far more compact clusters than morton clustering for curved
    dense geometry (fur balls: sum-of-cluster-volume drops ~5-10x), which
    directly cuts traversal rounds. The partition runs in the native C++
    splitter (native/bvh_builder.cpp — threaded nth_element, the CPU_BVH
    partition analog) with a loop-free numpy lexsort fallback; prefer the
    on-device morton `build` inside jit or for dynamic geometry.
    """
    bmin = np.asarray(prim_bmin, np.float32)
    bmax = np.asarray(prim_bmax, np.float32)
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))

    from .. import native
    res = native.median_split(cent, n_leaves)
    if res is not None:
        order, bounds = res
        perm = _ranges_to_perm(order, bounds, n_leaves, leaf_size)
        return _finalize_host(perm, bmin, bmax, n_leaves, leaf_size)

    # numpy fallback: one vectorized lexsort pass per level (no per-segment
    # python loop — the host may be a slow/throttled VM)
    order = np.arange(n, dtype=np.int64)
    bounds = np.array([0, n], dtype=np.int64)
    for _ in range(n_leaves.bit_length() - 1):
        counts = np.diff(bounds)
        seg_of = np.repeat(np.arange(counts.shape[0]), counts)
        c = cent[order]
        # per-segment longest axis via segment-wise min/max
        n_seg = counts.shape[0]
        lo = np.full((n_seg, 3), np.float32(BIG))
        hi = np.full((n_seg, 3), np.float32(-BIG))
        np.minimum.at(lo, seg_of, c)
        np.maximum.at(hi, seg_of, c)
        axis = np.argmax(hi - lo, axis=1)
        key = c[np.arange(n), axis[seg_of]]
        idx = np.lexsort((key, seg_of))  # sorted within each segment
        order = order[idx]
        mids = bounds[:-1] + (counts + 1) // 2
        bounds = np.sort(np.concatenate([bounds, mids]))
    perm = _ranges_to_perm(order, bounds, n_leaves, leaf_size)
    return _finalize_host(perm, bmin, bmax, n_leaves, leaf_size)


def _finalize_host(perm, bmin, bmax, n_leaves, leaf_size) -> BVH:
    """Shared tail of the host-side builders: leaf AABB reduction over the
    slot permutation + bottom-up level concatenation into heap order.
    Leaves stay numpy — one batched device transfer happens at to_device /
    the jit boundary."""
    keep = perm >= 0
    safe = np.maximum(perm, 0)
    sbmin = bmin[safe]
    sbmax = bmax[safe]
    sbmin[~keep] = np.float32(BIG)   # in-place: only padding rows touched
    sbmax[~keep] = np.float32(-BIG)

    lmin = sbmin.reshape(n_leaves, leaf_size, 3).min(axis=1)
    lmax = sbmax.reshape(n_leaves, leaf_size, 3).max(axis=1)
    levels_min, levels_max = [lmin], [lmax]
    while levels_min[0].shape[0] > 1:
        levels_min.insert(0, levels_min[0].reshape(-1, 2, 3).min(axis=1))
        levels_max.insert(0, levels_max[0].reshape(-1, 2, 3).max(axis=1))
    return BVH(bmin=np.concatenate(levels_min, 0),
               bmax=np.concatenate(levels_max, 0),
               perm=perm.astype(np.int32), packed=None,
               n_leaves=n_leaves, leaf_size=leaf_size)


@partial(jax.jit, static_argnames=("n_leaves", "leaf_size"))
def _finalize_device(perm, bmin, bmax, n_leaves, leaf_size):
    """Device-side twin of _finalize_host's AABB phase: leaf reduction over
    the slot permutation + bottom-up heap concatenation, as ONE jit (a 9M-
    prim hair ball finalizes in ms of HBM bandwidth instead of seconds of
    host numpy). Same math, same f32 ops — bit-identical to the host path."""
    keep = perm >= 0
    safe = jnp.maximum(perm, 0)
    sbmin = jnp.where(keep[:, None], bmin[safe], jnp.float32(BIG))
    sbmax = jnp.where(keep[:, None], bmax[safe], jnp.float32(-BIG))
    lmin = sbmin.reshape(n_leaves, leaf_size, 3).min(axis=1)
    lmax = sbmax.reshape(n_leaves, leaf_size, 3).max(axis=1)
    levels_min, levels_max = [lmin], [lmax]
    while levels_min[0].shape[0] > 1:
        levels_min.insert(0, levels_min[0].reshape(-1, 2, 3).min(axis=1))
        levels_max.insert(0, levels_max[0].reshape(-1, 2, 3).max(axis=1))
    return jnp.concatenate(levels_min, 0), jnp.concatenate(levels_max, 0)


def build_sah(prim_bmin, prim_bmax, leaf_size: int = 256,
              n_bins: int = 16) -> BVH:
    """Host-side capacity-clamped binned-SAH build.

    The same 16-bin surface-area-heuristic split family as KIRK's CPU BVH
    (CPU_BVH.cpp:357-461: per-axis centroid bins, incremental left/right
    AABB sweeps, SA_L·N_L + SA_R·N_R cost) and the GPU builder
    (bvh_constructSAH.compute), constrained so each side fits its implicit
    subtree's slot capacity (this container is a complete tree — see BVH).
    Falls back to the median plane when no binned plane satisfies the
    capacity clamp.
    """
    bmin = np.asarray(prim_bmin, np.float32)
    bmax = np.asarray(prim_bmax, np.float32)
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    n_slots = n_leaves * leaf_size

    order = np.arange(n)
    bounds = [0, n]
    n_levels = n_leaves.bit_length() - 1
    for level in range(n_levels):
        cap = (n_leaves >> (level + 1)) * leaf_size  # slots per child subtree
        new_bounds = [0]
        for s, e in zip(bounds[:-1], bounds[1:]):
            seg = order[s:e]
            cnt = e - s
            if cnt <= 1:
                new_bounds.extend([s + (cnt + 1) // 2, e])
                continue
            c = cent[seg]
            k_lo, k_hi = max(cnt - cap, 0), min(cnt, cap)
            k = best = None
            clo, chi = c.min(axis=0), c.max(axis=0)
            for axis in range(3):
                ext = chi[axis] - clo[axis]
                if ext <= 0.0:
                    continue
                # bin prims by centroid; sweep prefix/suffix bin AABBs
                b = np.minimum((c[:, axis] - clo[axis]) / ext * n_bins,
                               n_bins - 1).astype(np.int64)
                counts = np.bincount(b, minlength=n_bins)
                bb_lo = np.full((n_bins, 3), np.float32(BIG))
                bb_hi = np.full((n_bins, 3), np.float32(-BIG))
                np.minimum.at(bb_lo, b, bmin[seg])
                np.maximum.at(bb_hi, b, bmax[seg])
                # prefix (left) and suffix (right) running unions
                lmin = np.minimum.accumulate(bb_lo, axis=0)
                lmax = np.maximum.accumulate(bb_hi, axis=0)
                rmin = np.minimum.accumulate(bb_lo[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(bb_hi[::-1], axis=0)[::-1]
                n_l = np.cumsum(counts)[:-1]  # plane after bin i
                n_r = cnt - n_l

                def area(lo, hi):
                    d = np.maximum(hi - lo, 0.0)
                    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

                cost = (area(lmin[:-1], lmax[:-1]) * n_l
                        + area(rmin[1:], rmax[1:]) * n_r)
                ok = (n_l >= k_lo) & (n_l <= k_hi)
                if not ok.any():
                    continue
                cost = np.where(ok, cost, np.inf)
                i = int(np.argmin(cost))
                if best is None or cost[i] < best:
                    best = cost[i]
                    k = int(n_l[i])
                    side = (b > i).astype(np.int8)
            if k is None:  # degenerate extent / no clamped plane: median
                axis = int(np.argmax(chi - clo))
                k = min(max((cnt + 1) // 2, k_lo), k_hi)
                part = np.argpartition(c[:, axis], min(k, cnt - 1))
                order[s:e] = seg[part]
            else:
                order[s:e] = seg[np.argsort(side, kind="stable")]
            new_bounds.extend([s + k, e])
        bounds = new_bounds

    perm = np.full((n_slots,), -1, np.int64)
    for li, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
        cnt = e - s
        if cnt > leaf_size:
            raise AssertionError("SAH split produced oversized leaf")
        perm[li * leaf_size: li * leaf_size + cnt] = order[s:e]
    return _finalize_host(perm, bmin, bmax, n_leaves, leaf_size)


def build_grid(prim_bmin, prim_bmax, leaf_size: int = 256,
               resolution: int | None = None) -> BVH:
    """Host-side uniform-grid clustering (UniformGrid.h:12-50 analog).

    Primitives are binned by centroid into a G³ raster of cells and packed
    into fixed-size clusters in cell order; cluster AABBs are the tight
    bounds of their contents. The 3D-DDA cell walk of the reference becomes
    the same near-to-far entry-distance sweep every clustering here uses —
    on a wavefront machine, sorting cluster entry distances IS the DDA,
    amortized over all rays (see `traverse`).
    """
    bmin = np.asarray(prim_bmin, np.float32)
    bmax = np.asarray(prim_bmax, np.float32)
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    n_leaves = _next_pow2(max(-(-n // leaf_size), 1))
    n_slots = n_leaves * leaf_size
    if resolution is None:
        resolution = max(int(np.ceil((n / max(leaf_size, 1)) ** (1.0 / 3.0))), 1)
    g = int(resolution)

    lo = cent.min(axis=0)
    extent = np.maximum(cent.max(axis=0) - lo, 1e-12)
    ijk = np.minimum((cent - lo) / extent * g, g - 1).astype(np.int64)
    cell = (ijk[:, 0] * g + ijk[:, 1]) * g + ijk[:, 2]
    order = np.argsort(cell, kind="stable")

    perm = np.full((n_slots,), -1, np.int64)
    perm[:n] = order
    return _finalize_host(perm, bmin, bmax, n_leaves, leaf_size)


def _take_padded(x, safe, keep, pad_val):
    """x[safe] with padding rows (where ~keep) set to pad_val. numpy path:
    in-place assignment on the (few) padding rows instead of a full-size
    where pass — the where doubled reorder traffic (7.6 s at 9M cones)."""
    g = x[safe]
    if isinstance(g, np.ndarray):
        g[~keep] = pad_val
        return g
    mask = keep.reshape((-1,) + (1,) * (g.ndim - 1))
    return jnp.where(mask, g, pad_val)


def reorder_tris(tris: TrianglePack, bvh: BVH) -> TrianglePack:
    """Morton-reorder + pad the pack so leaf rows are contiguous; padding
    rows are all-zero degenerate triangles (det==0 ⇒ never hit)."""
    xp = _xp(bvh.perm)
    safe = xp.maximum(bvh.perm, 0)
    keep = (bvh.perm >= 0)
    return jax.tree.map(lambda x: _take_padded(x, safe, keep, 0), tris)


def reorder_cones(cones: ConePack, bvh: BVH) -> ConePack:
    """Same for cones; padding rows get an empty axis slab (min_d > max_d)."""
    xp = _xp(bvh.perm)
    safe = xp.maximum(bvh.perm, 0)
    keep = (bvh.perm >= 0)
    out = jax.tree.map(lambda x: _take_padded(x, safe, keep, 0), cones)
    return out.replace(
        min_d=_take_padded(cones.min_d, safe, keep, 1.0),
        max_d=_take_padded(cones.max_d, safe, keep, -1.0),
    )


def debug_info(bvh: BVH) -> dict:
    """Structure statistics — TreeAccel::printDebugInfo analog
    (TreeAccel.h:80-86: node/leaf/depth counts) plus the quality metrics
    that actually predict traversal cost here: total SAH cost
    (Σ leaf_area·leaf_count / root_area) and occupancy."""
    n_leaves, k = bvh.n_leaves, bvh.leaf_size
    leaf_base = n_leaves - 1
    lo = np.asarray(bvh.bmin)
    hi = np.asarray(bvh.bmax)
    perm = np.asarray(bvh.perm).reshape(n_leaves, k)
    counts = (perm >= 0).sum(axis=1)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    leaf_area = area(lo[leaf_base:], hi[leaf_base:])
    root_area = float(area(lo[:1], hi[:1])[0])
    return {
        "n_nodes": int(2 * n_leaves - 1),
        "n_leaves": int(n_leaves),
        "leaf_size": int(k),
        "depth": bvh.depth,
        "n_prims": int(counts.sum()),
        "occupancy": float(counts.mean() / k),
        "sah_cost": float((leaf_area * counts).sum() / max(root_area, 1e-30)),
    }


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _slab_grid(o, inv_d, bmin, bmax, t_max):
    """Dense all-pairs slab test. o/inv_d [R,3], boxes [C,3] -> t_near [R,C]
    with INF where missed. Pure broadcast work — no gathers; per-axis
    [R,C] math, not an [R,C,3] layout."""
    tnear = jnp.full((o.shape[0], bmin.shape[0]), -INF)
    tfar = jnp.full((o.shape[0], bmin.shape[0]), INF)
    for a in range(3):
        t0 = (bmin[None, :, a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        t1 = (bmax[None, :, a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        tnear = jnp.maximum(tnear, jnp.minimum(t0, t1))
        tfar = jnp.minimum(tfar, jnp.maximum(t0, t1))
    hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear < t_max[:, None])
    return jnp.where(hit, tnear, INF)


def _empty_state(r):
    """Resumable per-ray traversal cursor (see _traverse_chunk*): because
    min-extraction consumes boxes in increasing entry order, 'which boxes
    were already visited' compresses to the LAST consumed entry distance —
    6 scalars per ray instead of the [R, S] masked grids."""
    return {
        "t_best": jnp.full((r,), INF),
        "row_best": jnp.full((r,), -1, jnp.int32),
        "alive": jnp.zeros((r,), bool),
        "sup_cut": jnp.full((r,), -INF),  # entries < sup_cut are consumed
        "cur_sid": jnp.full((r,), -1, jnp.int32),
        "child_cut": jnp.full((r,), -INF),
    }


def _traverse_chunk(bvh: BVH, o, d, leaf_fn, t_min, t_max, any_hit,
                    max_rounds, resume=None):
    """Flat culled-cluster traversal for one ray chunk. See `traverse`.

    Min-EXTRACTION schedule, not a sort: each round every ray takes the
    nearest not-yet-visited cluster (argmin over its masked entry-distance
    row) and masks it off. Near-to-far pruning is identical to a sorted
    sweep — the extracted minimum IS the next cluster in entry order — but
    needs no sort: one argmin+mask round per visited cluster instead of a
    full [R, C] sort per chunk.

    `resume` (from a bounded-round earlier pass) restarts exactly: consumed
    clusters are those with entry < sup_cut (a tie at the cutoff may be
    re-visited — wasted work, never a wrong result)."""
    r = o.shape[0]
    n_c = bvh.n_leaves
    k = bvh.leaf_size
    leaf_base = n_c - 1
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)

    if resume is None:
        t_best0 = t_max
        row_best0 = jnp.full((r,), -1, jnp.int32)
        alive0 = jnp.ones((r,), bool)
        cut0 = jnp.full((r,), -INF)
    else:
        t_best0 = resume["t_best"]
        row_best0 = resume["row_best"]
        alive0 = resume["alive"]
        cut0 = resume["sup_cut"]

    # Phase 1 (dense): entry distance to every cluster box. [R, C]
    tn = _slab_grid(o, inv_d, bvh.bmin[leaf_base:], bvh.bmax[leaf_base:],
                    t_best0)
    tn = jnp.where(tn < cut0[:, None], INF, tn)  # consumed in earlier pass
    col = jnp.arange(n_c, dtype=jnp.int32)[None]

    if max_rounds is None:
        max_rounds = n_c
    max_rounds = jnp.int32(min(max_rounds, n_c))

    def cond(carry):
        rnd, tn, t_best, row_best, alive, cut = carry
        return (rnd < max_rounds) & jnp.any(alive)

    def body(carry):
        rnd, tn, t_best, row_best, alive, cut = carry
        j = jnp.argmin(tn, axis=-1).astype(jnp.int32)  # nearest unvisited
        ct = _take1(tn, j)
        alive = alive & (ct < t_best)  # sorted-order prune: rest only farther
        cut = jnp.where(alive, ct, cut)
        t_cand = leaf_fn(o, d, j, t_min, t_best)  # [R, k]
        t_cand = jnp.where(alive[:, None], t_cand, INF)
        jj = jnp.argmin(t_cand, axis=-1)
        t_new = _take1(t_cand, jj.astype(jnp.int32))
        better = t_new < t_best
        t_best = jnp.where(better, t_new, t_best)
        row_best = jnp.where(better, j * k + jj.astype(jnp.int32), row_best)
        tn = jnp.where(col == j[:, None], INF, tn)  # mark visited
        if any_hit:
            alive = alive & ~(row_best >= 0)
        return rnd + 1, tn, t_best, row_best, alive, cut

    init = (jnp.int32(0), tn, t_best0, row_best0, alive0, cut0)
    out = jax.lax.while_loop(cond, body, init)
    _, _, t_best, row_best, alive, cut = out
    state = _empty_state(r)
    state.update(t_best=t_best, row_best=row_best, alive=alive, sup_cut=cut)
    return t_best, row_best, row_best >= 0, state


def _slab_grouped(o, inv_d, bmin_g, bmax_g, t_best):
    """Slab test of each ray against ITS OWN group of boxes.
    o/inv_d [R,3], boxes [R,F,3] -> t_near [R,F] with INF where missed."""
    r, f = bmin_g.shape[0], bmin_g.shape[1]
    tnear = jnp.full((r, f), -INF)
    tfar = jnp.full((r, f), INF)
    for a in range(3):
        t0 = (bmin_g[:, :, a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        t1 = (bmax_g[:, :, a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        tnear = jnp.maximum(tnear, jnp.minimum(t0, t1))
        tfar = jnp.minimum(tfar, jnp.maximum(t0, t1))
    hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear < t_best[:, None])
    return jnp.where(hit, tnear, INF)


def _take1(arr2d, idx):
    """arr2d[r, idx[r]] -> [R]."""
    return jnp.take_along_axis(arr2d, idx[:, None], axis=1)[:, 0]


def _traverse_chunk_hier(bvh: BVH, o, d, leaf_fn, t_min, t_max, any_hit,
                         max_rounds, resume=None):
    """Two-level culled-cluster traversal for one ray chunk.

    The flat scheme's phase 1 materializes an O(R·C) entry grid — fine to
    C≈512, ruinous at the 10^5 leaf clusters of a 1M-fiber hair ball
    (SURVEY hard part d). Here the implicit tree's level at n_leaves/fanout
    supplies S = C/F super-cluster AABBs: rays min-extract supers
    near-to-far from a masked [R, S] entry grid; entering a super
    slab-tests only its F children ([R, F] gather of contiguous box rows)
    which are then min-extracted the same way. Pruning is identical
    (entry < best-hit), so results match the flat traversal and the
    brute-force oracle bit-for-bit; only the visit schedule changes. Cost
    per round: one [R, F, 6] box gather + one [R, W·K] leaf gather + dense
    [R, K] intersection + [R, S] and [R, F] min passes — every term is
    per-ray-bounded instead of scene-bounded, and nothing is sorted.
    """
    r = o.shape[0]
    n_c = bvh.n_leaves
    k = bvh.leaf_size
    f = bvh.fanout
    s = n_c // f
    leaf_base = n_c - 1
    sup_base = s - 1
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)

    # child (leaf-cluster) boxes grouped per super: contiguous heap rows
    cb_min = bvh.bmin[leaf_base:leaf_base + n_c].reshape(s, f, 3)
    cb_max = bvh.bmax[leaf_base:leaf_base + n_c].reshape(s, f, 3)

    if resume is None:
        t_best0 = t_max
        row_best0 = jnp.full((r,), -1, jnp.int32)
        alive0 = jnp.ones((r,), bool)
        sup_cut0 = jnp.full((r,), -INF)
        cur_sid0 = jnp.full((r,), -1, jnp.int32)
        child_cut0 = jnp.full((r,), -INF)
    else:
        t_best0 = resume["t_best"]
        row_best0 = resume["row_best"]
        alive0 = resume["alive"]
        sup_cut0 = resume["sup_cut"]
        cur_sid0 = resume["cur_sid"]
        child_cut0 = resume["child_cut"]

    # Phase 1 (dense, once): entry distance to every SUPER box. NO sort —
    # supers and children are consumed by min-extraction (see
    # _traverse_chunk).
    sup_t = _slab_grid(o, inv_d, bvh.bmin[sup_base:sup_base + s],
                       bvh.bmax[sup_base:sup_base + s], t_best0)  # [R, S]
    scol = jnp.arange(s, dtype=jnp.int32)[None]
    fcol = jnp.arange(f, dtype=jnp.int32)[None]
    # resume: supers consumed before (entry strictly below the cutoff, plus
    # the in-progress one); a tie at the cutoff is re-visited — waste only
    sup_t = jnp.where((sup_t < sup_cut0[:, None])
                      | (scol == cur_sid0[:, None]), INF, sup_t)
    # rebuild the in-progress super's remaining children
    sid0 = jnp.maximum(cur_sid0, 0)
    tn_c0 = _slab_grouped(o, inv_d, cb_min[sid0], cb_max[sid0], t_best0)
    tn_c0 = jnp.where(tn_c0 < child_cut0[:, None], INF, tn_c0)
    child_t0 = jnp.where((cur_sid0 >= 0)[:, None], tn_c0, INF)

    if max_rounds is None:
        max_rounds = s + n_c  # every super + every cluster once (safe bound)
    max_rounds = jnp.int32(max_rounds)

    def cond(c):
        (rnd, t_best, row_best, sup_t, child_t, cur_sid, alive, sup_cut,
         child_cut) = c
        return (rnd < max_rounds) & jnp.any(alive)

    def body(c):
        (rnd, t_best, row_best, sup_t, child_t, cur_sid, alive, sup_cut,
         child_cut) = c
        # 1. rays whose current super has no remaining useful child advance
        #    to the nearest unvisited super; if even that can't beat the
        #    best hit, the ray is done (entries only grow, best only drops).
        cmin_idx = jnp.argmin(child_t, axis=-1).astype(jnp.int32)
        cmin = _take1(child_t, cmin_idx)
        need_sup = alive & (cmin >= t_best)
        smin_idx = jnp.argmin(sup_t, axis=-1).astype(jnp.int32)  # = super id
        smin = _take1(sup_t, smin_idx)
        expand = need_sup & (smin < t_best)
        alive = alive & (~need_sup | expand)
        sup_t = jnp.where((need_sup[:, None]) & (scol == smin_idx[:, None]),
                          INF, sup_t)  # mark visited
        sup_cut = jnp.where(expand, smin, sup_cut)
        child_cut = jnp.where(expand, -INF, child_cut)
        cur_sid = jnp.where(expand, smin_idx, cur_sid)

        # 2. expand: slab-test the new super's F children
        tn_c = _slab_grouped(o, inv_d, cb_min[jnp.maximum(cur_sid, 0)],
                             cb_max[jnp.maximum(cur_sid, 0)], t_best)
        child_t = jnp.where(expand[:, None], tn_c, child_t)

        # 3. visit the nearest remaining child cluster (same round as the
        #    expansion, so advancing costs no extra leaf round)
        cmin_idx = jnp.argmin(child_t, axis=-1).astype(jnp.int32)
        cmin = _take1(child_t, cmin_idx)
        active = alive & (cmin < t_best)
        child_cut = jnp.where(active, cmin, child_cut)
        cl = jnp.maximum(cur_sid, 0) * f + cmin_idx
        t_cand = leaf_fn(o, d, cl, t_min, t_best)  # [R, k]
        t_cand = jnp.where(active[:, None], t_cand, INF)
        j = jnp.argmin(t_cand, axis=-1)
        t_new = _take1(t_cand, j.astype(jnp.int32))
        better = t_new < t_best
        t_best = jnp.where(better, t_new, t_best)
        row_best = jnp.where(better, cl * k + j.astype(jnp.int32), row_best)
        child_t = jnp.where(active[:, None] & (fcol == cmin_idx[:, None]),
                            INF, child_t)
        if any_hit:
            alive = alive & ~(row_best >= 0)
        return (rnd + 1, t_best, row_best, sup_t, child_t, cur_sid, alive,
                sup_cut, child_cut)

    init = (jnp.int32(0), t_best0, row_best0, sup_t, child_t0, cur_sid0,
            alive0, sup_cut0, child_cut0)
    out = jax.lax.while_loop(cond, body, init)
    (_, t_best, row_best, _, _, cur_sid, alive, sup_cut, child_cut) = out
    state = {"t_best": t_best, "row_best": row_best, "alive": alive,
             "sup_cut": sup_cut, "cur_sid": cur_sid, "child_cut": child_cut}
    return t_best, row_best, row_best >= 0, state


def traverse(bvh: BVH, o, d, leaf_fn: Callable, t_min, t_max,
             any_hit: bool = False, max_rounds: int | None = None,
             chunk: int = 16384, n_alive=None):
    """Nearest-hit traversal for a ray wavefront, in lock-step.

    Instead of a per-ray node automaton, rays test ALL cluster AABBs
    densely, then sweep clusters near-to-far in lock-step rounds; each round performs
    one bulk contiguous gather of `leaf_size` primitives per ray plus a dense
    intersection. The sweep stops per-ray as soon as the next cluster's entry
    distance exceeds the current best hit — the same near-to-far pruning as
    BVHNode::traverse (CPU_BVH.cpp:148-199), amortized over the wavefront.

    leaf_fn(o, d, cl [R] int32 cluster ids, t_min, t_best) -> t [R, leaf_size]
        candidate hit distances (INF where miss) for the clusters' rows of
        the packed geometry (see tri_leaf_packed / cone_leaf_packed).

    Returns (t_best [R], row_best [R] int32 row in the reordered pack,
    hit_found [R] bool). With any_hit=True rays stop at the first accepted
    hit (shadow semantics; t/row are then *a* hit, not the nearest).
    """
    from ..scene.types import ensure_device
    bvh = ensure_device(bvh)
    r = o.shape[0]
    hier = bvh.fanout and bvh.fanout < bvh.n_leaves
    chunk_fn = _traverse_chunk_hier if hier else _traverse_chunk
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)
    if r <= chunk:
        out = chunk_fn(bvh, o, d, leaf_fn, t_min, t_max_arr, any_hit, max_rounds)
        return out[0], out[1], out[2]

    pad = (-r) % chunk
    rp = r + pad
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    t_p = jnp.pad(t_max_arr, (0, pad))
    n_chunks = rp // chunk

    def run_pass(o_f, d_f, t_f, rounds, gate, resume_f):
        starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
        res_c = (None if resume_f is None else
                 jax.tree.map(lambda x: x.reshape((n_chunks, chunk) + x.shape[1:]),
                              resume_f))

        def one(args):
            oo, dd, tt, start, res = args

            def work():
                return chunk_fn(bvh, oo, dd, leaf_fn, t_min, tt, any_hit,
                                rounds, resume=res)

            if gate is None:
                return work()
            # compacted wavefront: whole-dead chunks skip even the dense
            # phase-1 slab grid (pt_sortHits.compute analog)
            def skip():
                st = _empty_state(chunk)
                if res is not None:
                    st = res
                return (st["t_best"], st["row_best"],
                        st["row_best"] >= 0, st)

            return jax.lax.cond(start < gate, work, skip)

        args = (o_f.reshape(-1, chunk, 3), d_f.reshape(-1, chunk, 3),
                t_f.reshape(-1, chunk), starts)
        if res_c is None:
            out = jax.lax.map(lambda a: one(a + (None,)), args)
        else:
            out = jax.lax.map(one, args + (res_c,))
        return jax.tree.map(
            lambda x: x.reshape((rp,) + x.shape[2:]), out)

    if max_rounds is not None or n_chunks < 2:
        t, row, found, _ = run_pass(o_p, d_p, t_p, max_rounds, n_alive, None)
        return t[:r], row[:r], found[:r]

    # Two-pass survivor compaction: pass 1 gives every ray a bounded number
    # of rounds; unfinished rays (the divergent tail that otherwise holds
    # ALL lanes of its chunk hostage) are compacted to the front and
    # finished in as few chunks as they fill — the traversal-level
    # pt_sortHits analog. Exact: the resume cursor replays the schedule.
    t1, row1, found1, st1 = run_pass(o_p, d_p, t_p, PASS1_ROUNDS, n_alive,
                                     None)
    alive1 = st1["alive"]
    from .compact import compaction_permutation, invert_permutation
    perm, n_alive2 = compaction_permutation(alive1)
    inv = invert_permutation(perm)
    o_c = o_p[perm]
    d_c = d_p[perm]
    t_c = t_p[perm]
    st_c = jax.tree.map(lambda x: x[perm], st1)
    t2, row2, found2, _ = run_pass(o_c, d_c, t_c, None, n_alive2, st_c)
    t2, row2, found2 = t2[inv], row2[inv], found2[inv]
    t = jnp.where(alive1, t2, t1)
    row = jnp.where(alive1, row2, row1)
    found = jnp.where(alive1, found2, found1)
    return t[:r], row[:r], found[:r]


# ---------------------------------------------------------------------------
# Leaf intersection functions
#
# *_leaf_packed — traversal-time: ONE [R, W*K] cluster-row gather from
# bvh.packed, then dense [R, K] component math. The differentiable
# winner-t recompute outside the loop lives in ops/traverse.py.
# ---------------------------------------------------------------------------

def _tri_core(o, d, comp, t_min, t_best):
    """Component-wise Möller–Trumbore. o/d [R,3]; comp: 9 × [R,K] arrays
    (v0, e1, e2 per component). Same math as intersect.triangle_hit_grid."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = comp
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    # p = d × e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near_zero = jnp.abs(det) < isect.TRI_EPS
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # q = tvec × e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((~near_zero) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > t_min) & (t < t_best[:, None]))
    return jnp.where(ok, t, INF)


def _cone_core(o, d, comp, t_min, t_best):
    """Component-wise KIRK cone quadratic (intersect.cone_hit_grid math).
    comp: 16 × [R,K] arrays (base, u, v, w per component, slope, r_base,
    min_d, max_d)."""
    (bx, by, bz, ux, uy, uz, vx, vy, vz, wx, wy, wz,
     slope, r_base, min_d, max_d) = comp
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    ddx, ddy, ddz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    rx, ry, rz = ox - bx, oy - by, oz - bz
    px = rx * ux + ry * uy + rz * uz
    py = rx * vx + ry * vy + rz * vz
    pz = rx * wx + ry * wy + rz * wz
    dx = ddx * ux + ddy * uy + ddz * uz
    dy = ddx * vx + ddy * vy + ddz * vz
    dz = ddx * wx + ddy * wy + ddz * wz

    a = dx * dx + dz * dz - slope * slope * dy * dy
    b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    c_lin = r_base - slope * py
    c = px * px + pz * pz - c_lin * c_lin

    disc = b * b - a * c
    has_roots = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    a_safe = jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    t1 = (-b - sq) / a_safe
    t2 = (-b + sq) / a_safe
    t1, t2 = jnp.minimum(t1, t2), jnp.maximum(t1, t2)

    # axis slab: d_axis(t) = (o + t d)·v = (py + base·v) + t dy; since
    # py = (o-base)·v, d_axis = py + t*dy + base·v — but min_d/max_d are in
    # the same absolute frame, so reconstruct via o·v = py + base·v.
    ov = oy * vy + ox * vx + oz * vz

    def axis_ok(t):
        dax = ov + t * dy
        return (dax >= min_d) & (dax <= max_d)

    tb = t_best[:, None]
    t1_ok = (t1 >= 1e-4) & (t1 > t_min) & (t1 < tb) & axis_ok(t1)
    t2_ok = (t2 >= 1e-4) & (t2 > t_min) & (t2 < tb) & axis_ok(t2)
    take1 = has_roots & t1_ok
    take2 = has_roots & (~t1_ok) & t2_ok
    return jnp.where(take1, t1, jnp.where(take2, t2, INF))


def tri_leaf_packed(bvh: BVH):
    """Traversal leaf fn over bvh.packed [C, 9, K]."""
    packed = jnp.asarray(bvh.packed) if isinstance(bvh.packed, np.ndarray) else bvh.packed

    def fn(o, d, cl, t_min, t_best):
        blk = packed[cl]  # [R, 9, K] — one contiguous row gather
        comp = [blk[:, i] for i in range(9)]
        return _tri_core(o, d, comp, t_min, t_best)

    return fn


def cone_leaf_packed(bvh: BVH):
    """Traversal leaf fn over bvh.packed [C, 16, K]."""
    packed = jnp.asarray(bvh.packed) if isinstance(bvh.packed, np.ndarray) else bvh.packed

    def fn(o, d, cl, t_min, t_best):
        blk = packed[cl]  # [R, 16, K]
        comp = [blk[:, i] for i in range(16)]
        return _cone_core(o, d, comp, t_min, t_best)

    return fn
