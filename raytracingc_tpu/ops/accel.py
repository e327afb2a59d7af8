"""Block-AABB acceleration structure: Morton-sorted blocks with bounds.

The reference scans every triangle for every ray (``raytracing.c:229-237``) —
O(R·T) with no acceleration structure. The structure here is flat rather
than a pointer-chasing BVH:

* Triangles are sorted by the Morton code of their centroid (host-side, at
  scene build), clustering spatially-near triangles into contiguous runs.
* Each aligned block of ``BLOCK`` triangles gets an AABB.

The permuted resolve (``ops.intersect.with_perm_resolve``), block sharding
and geometry training (``refresh_accel``) read it today; a culling search
that skips blocks whose AABB a ray misses is the next consumer. Such a
search must carry ORIGINAL triangle indices and break distance ties toward
the lowest original index, so its results stay bit-identical to the
unsorted brute-force scan (and to the C scan order).
"""

from __future__ import annotations

import jax
import numpy as np

from raytracingc_tpu.scene.types import Triangles
from raytracingc_tpu.utils.pytree import pytree_node

# Triangles per AABB block. Scene padding and block sharding use the same
# multiple. Not yet measured against other sizes on the GPU.
BLOCK = 128
_AABB_BIG = 3.0e38  # bound of the inverted AABB of padding-only blocks


@pytree_node
class TriangleAccel:
    """Morton-permuted triangle soup + per-block AABBs.

    ``triangles``: permuted copy of the scene's triangle SoA (padding at the
    tail). ``orig_idx`` maps permuted slot → original triangle index (padding
    slots map to a large sentinel so they lose every tie). ``aabb_lo/hi``:
    ``[B, 3]`` block bounds; padding-only blocks get an inverted AABB that no
    ray can hit.
    """

    triangles: Triangles
    orig_idx: jax.Array  # int32 [T]
    aabb_lo: jax.Array  # f32 [B, 3]
    aabb_hi: jax.Array  # f32 [B, 3]
    # Inverse permutation: original triangle id → permuted slot (int32 [T]).
    # Lets the resolve gather run against Morton-permuted (locality-sorted)
    # tables: the search winner's ORIGINAL index maps to its permuted slot,
    # where spatially-near winners sit in nearby rows. None on trivial
    # accels.
    perm_of_orig: jax.Array | None = None


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz quantized coords into a 30-bit Morton code."""

    def split(v: np.ndarray) -> np.ndarray:
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    x, y, z = (split(q[:, i].astype(np.uint32)) for i in range(3))
    return x | (y << 1) | (z << 2)


def build_accel(tris: Triangles, n_live: int) -> TriangleAccel:
    """Sort live triangles by centroid Morton code and compute block AABBs."""
    t = tris.a.shape[0]
    a = np.asarray(tris.a)
    b = np.asarray(tris.b)
    c = np.asarray(tris.c)

    if n_live > 0:
        cent = (a[:n_live] + b[:n_live] + c[:n_live]) / 3.0
        lo = cent.min(axis=0)
        span = np.maximum(cent.max(axis=0) - lo, 1e-12)
        q = np.clip(((cent - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable").astype(np.int32)
    else:
        order = np.zeros((0,), np.int32)
    perm = np.concatenate([order, np.arange(n_live, t, dtype=np.int32)])

    def take(x):
        return jax.numpy.asarray(np.asarray(x)[perm])

    permuted = Triangles(
        a=take(tris.a),
        b=take(tris.b),
        c=take(tris.c),
        normal=take(tris.normal),
        albedo=take(tris.albedo),
        emission=take(tris.emission),
        smoothness=take(tris.smoothness),
    )
    # Padding slots get a huge original index: they can never win a tie (they
    # also never hit — zero normals fail the backface test).
    orig = perm.copy()
    orig[n_live:] = 2**30

    n_blocks = t // BLOCK
    pa, pb, pc = a[perm], b[perm], c[perm]
    lo_blocks = np.full((n_blocks, 3), _AABB_BIG, np.float32)
    hi_blocks = np.full((n_blocks, 3), -_AABB_BIG, np.float32)
    for blk in range(n_blocks):
        s, e = blk * BLOCK, min((blk + 1) * BLOCK, n_live)
        if s >= n_live:
            continue  # padding-only block: inverted AABB, never hit
        vs = np.concatenate([pa[s:e], pb[s:e], pc[s:e]], axis=0)
        lo_blocks[blk] = vs.min(axis=0)
        hi_blocks[blk] = vs.max(axis=0)

    # Inverse permutation (original id → permuted slot). ``perm`` is a true
    # permutation of [0, t) (padding tail rides along identity-ish), so the
    # inverse is total; padding ids are simply never queried by winners.
    inv = np.empty((t,), np.int32)
    inv[perm] = np.arange(t, dtype=np.int32)

    return TriangleAccel(
        triangles=permuted,
        orig_idx=jax.numpy.asarray(orig),
        aabb_lo=jax.numpy.asarray(lo_blocks),
        aabb_hi=jax.numpy.asarray(hi_blocks),
        perm_of_orig=jax.numpy.asarray(inv),
    )


def refresh_accel(
    accel: TriangleAccel, tris: Triangles, n_live: int
) -> TriangleAccel:
    """Recompute the accel's VALUES from current geometry, keeping its
    static permutation — the geometry-training accel.

    ``build_accel`` freezes a geometry copy; training vertices makes that
    copy stale after the first update (its block bounds would no longer
    bound the moved triangles). This traced rebuild keeps the host-built
    Morton ORDER (``orig_idx``/``perm_of_orig``, ints — the only part that
    needs a host sort) and regenerates the values — permuted triangle SoA
    and per-block AABBs — from ``tris`` INSIDE the trace. The result is
    exact for the current geometry at every step (AABBs always bound the triangles
    assigned to their block); only the *culling quality* ages as vertices
    drift from the order's Morton sort, which is a performance property,
    not a correctness one. Re-sort host-side every k steps
    (``fit_scene(accel_rebuild_every=k)``) to recover it.

    Values are bit-identical to ``build_accel`` on the same geometry and
    permutation (same gather rows, same min/max — pinned by
    ``tests/test_train_scale.py``).
    """
    import jax.numpy as jnp

    t = tris.a.shape[0]
    assert accel.perm_of_orig is not None, (
        "refresh_accel needs a real (host-built) accel; trivial accels "
        "carry no permutation to refresh"
    )
    assert accel.orig_idx.shape[0] == t, (accel.orig_idx.shape, t)
    # Padding slots carry the 2**30 sentinel original index; clip them onto
    # row t-1. Padding slots exist iff n_live < t, and then original rows
    # [n_live, t) are all-zero lane padding — so the clipped gather hands
    # every padding slot an inert all-zero row (zero normals fail the
    # backface test), exactly like build_accel's identity-mapped tail.
    src = jnp.minimum(accel.orig_idx, t - 1)

    permuted = jax.tree_util.tree_map(
        lambda x: jnp.take(x, src, axis=0), tris
    )

    # Per-block AABBs over LIVE slots only (live rows are exactly the first
    # n_live permuted slots). Padding rows would pollute the bounds with
    # their (0,0,0) vertices; masking them with +/-_AABB_BIG reproduces
    # build_accel's inverted never-hit AABB for padding-only blocks.
    n_blocks = t // BLOCK
    live = (jnp.arange(t, dtype=jnp.int32) < n_live)[:, None]
    stacked_lo = jnp.minimum(
        jnp.minimum(
            jnp.where(live, permuted.a, _AABB_BIG),
            jnp.where(live, permuted.b, _AABB_BIG),
        ),
        jnp.where(live, permuted.c, _AABB_BIG),
    ).reshape(n_blocks, BLOCK, 3)
    stacked_hi = jnp.maximum(
        jnp.maximum(
            jnp.where(live, permuted.a, -_AABB_BIG),
            jnp.where(live, permuted.b, -_AABB_BIG),
        ),
        jnp.where(live, permuted.c, -_AABB_BIG),
    ).reshape(n_blocks, BLOCK, 3)
    lo_blocks = stacked_lo.min(axis=1)
    hi_blocks = stacked_hi.max(axis=1)

    return TriangleAccel(
        triangles=permuted,
        orig_idx=accel.orig_idx,
        aabb_lo=lo_blocks,
        aabb_hi=hi_blocks,
        perm_of_orig=accel.perm_of_orig,
    )

