"""Ray–primitive intersection: search (argmin) + differentiable resolve.

The reference's hot loop is a brute-force closest-hit scan
(``calculateRayCollision``, ``raytracing.c:216-240``): all spheres, then all
triangles, argmin on distance starting from ``{didHit=0, dst=999999}``, with
Möller–Trumbore triangle tests that backface-cull against the precomputed face
normal (``raytracing.c:186-214``) and a simplified ray–sphere quadratic
(``raytracing.c:162-184``).

The search/resolve split:

1. **Search** finds, per ray, only *which* primitive wins (an int index and a
   hit flag). It is integer-valued, needs no gradients, and is the
   O(rays × primitives) hot loop: the chunked-``lax.scan`` XLA scan here
   (the oracle, and the CPU path) or the fused GPU kernel in
   ``search_triton.py``. ``nearest_hit`` picks one per platform.
2. **Resolve** gathers the winning primitive and recomputes distance, hit
   point, normal, and material *differentiably* — one MT evaluation per ray.
   Gradients of pixel values w.r.t. vertex positions/normals/materials flow
   through this recompute; the discrete argmin choice itself is (correctly)
   treated as locally constant, the standard subgradient for visibility.

Tie semantics match the C scan order: lower index wins among equal distances;
a sphere beats a triangle at equal distance (spheres are scanned first and
triangles only replace on strictly smaller distance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracingc_tpu.ops.search_triton import search_triangles_triton
from raytracingc_tpu.scene.types import EPSILON, MISS_DST, Scene, Spheres, Triangles
from raytracingc_tpu.utils.pytree import pytree_node


@pytree_node
class HitRef:
    """Per-ray search result: which primitive was hit (no geometry payload)."""

    hit: jax.Array  # bool [R]
    is_tri: jax.Array  # bool [R] (valid only where hit)
    idx: jax.Array  # int32 [R] primitive index (valid only where hit)


@pytree_node
class Hit:
    """Per-ray resolved hit: differentiable geometry + material."""

    hit: jax.Array  # bool [R]
    dst: jax.Array  # f32 [R] (MISS_DST sentinel where miss, like the C code)
    point: jax.Array  # f32 [R, 3]
    normal: jax.Array  # f32 [R, 3]
    albedo: jax.Array  # f32 [R, 3]
    emission: jax.Array  # f32 [R]
    smoothness: jax.Array  # f32 [R]


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def ray_triangle_dst(o, d, a, b, c, n):
    """Möller–Trumbore with backface cull (``raytracing.c:186-214``).

    All arguments broadcast; returns ``(dst, valid)``. ``dst`` is only
    meaningful where ``valid``; the division is guarded so invalid lanes carry
    finite values (no NaN/inf leaks into gradients).
    """
    ab = b - a
    ac = c - a
    backface = _dot(d, n) >= 0.0  # cull via the precomputed normal
    h = jnp.cross(d, ac)
    det = _dot(ab, h)
    degenerate = jnp.abs(det) < EPSILON
    inv_det = 1.0 / jnp.where(degenerate, 1.0, det)
    s = o - a
    u = _dot(s, h) * inv_det
    q = jnp.cross(s, ab)
    v = _dot(d, q) * inv_det
    dst = _dot(ac, q) * inv_det
    valid = (
        ~backface
        & ~degenerate
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (dst >= EPSILON)
    )
    return dst, valid


def ray_sphere_dst(o, d, center, radius):
    """Simplified quadratic, unit direction ⇒ a=1 (``raytracing.c:162-184``).

    Returns ``(dst, valid)``. Near root preferred; far root if the near one is
    behind ``EPSILON``. Non-positive radii (padding) never hit.
    """
    offset = o - center
    b = _dot(offset, d)
    cc = _dot(offset, offset) - radius * radius
    delta = b * b - cc
    miss = delta < 0.0
    sq = jnp.sqrt(jnp.where(miss, 0.0, delta))
    near = -b - sq
    far = -b + sq
    dst = jnp.where(near < EPSILON, far, near)
    valid = ~miss & (dst >= EPSILON) & (radius > 0.0)
    return dst, valid


# ----------------------------------------------------------------------------
# Search: the XLA scan over triangles, a full pass over spheres, dispatch.
# ----------------------------------------------------------------------------


def _search_triangles_xla(o, d, tris: Triangles, chunk: int = 512):
    """Running argmin over triangle chunks. Returns (best_dst, best_idx)."""
    t = tris.a.shape[0]
    # Largest divisor of t that fits the requested chunk: padded counts are
    # usually multiples of 128 (the accel block) but need not divide 512 —
    # e.g. 3968 = 31×128.
    chunk = min(chunk, t)
    while t % chunk:
        chunk -= 1
    n_chunks = t // chunk

    resh = lambda x: x.reshape(n_chunks, chunk, *x.shape[1:])
    stacked = (resh(tris.a), resh(tris.b), resh(tris.c), resh(tris.normal))

    def body(carry, chunk_data):
        best_dst, best_idx, base = carry
        a, b, c, n = chunk_data
        dst, valid = ray_triangle_dst(
            o[:, None, :], d[:, None, :], a[None], b[None], c[None], n[None]
        )  # [R, chunk]
        dst = jnp.where(valid, dst, MISS_DST)
        j = jnp.argmin(dst, axis=1)  # first index among equal minima
        dmin = jnp.min(dst, axis=1)  # == dst[j] for NaN-free data
        better = dmin < best_dst  # strict < keeps the earlier (lower) index
        best_dst = jnp.where(better, dmin, best_dst)
        best_idx = jnp.where(better, base + j.astype(jnp.int32), best_idx)
        return (best_dst, best_idx, base + chunk), None

    r = o.shape[0]
    init = (
        jnp.full((r,), MISS_DST, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.int32(0),
    )
    (best_dst, best_idx, _), _ = jax.lax.scan(body, init, stacked)
    return best_dst, best_idx


def _search_spheres(o, d, spheres: Spheres):
    """Full [R, S] sphere pass (sphere counts are tiny). Lower index wins ties."""
    dst, valid = ray_sphere_dst(
        o[:, None, :], d[:, None, :], spheres.center[None], spheres.radius[None]
    )
    dst = jnp.where(valid, dst, MISS_DST)
    idx = jnp.argmin(dst, axis=1).astype(jnp.int32)
    dmin = jnp.min(dst, axis=1)  # == dst[idx] for NaN-free data
    return dmin, jnp.where(dmin < MISS_DST, idx, -1)


# Implementations ``nearest_hit`` accepts by name. "triton-interpret" is the
# GPU kernel run by the Pallas interpreter: it lets CPU tests cover the
# kernel and is never chosen by "auto".
SEARCH_BACKENDS = ("xla", "triton", "triton-interpret")


def resolve_backend(backend: str) -> str:
    """Map ``"auto"`` to the search for ``jax.default_backend()``.

    ``"gpu"`` gets the fused kernel (``"triton"``), ``"cpu"`` the XLA scan;
    any other platform raises. Explicit names pass through unchanged.
    """
    if backend == "auto":
        platform = jax.default_backend()
        if platform == "gpu":
            return "triton"
        if platform == "cpu":
            return "xla"
        raise ValueError(f"no search backend for platform {platform!r}")
    if backend not in SEARCH_BACKENDS:
        raise ValueError(
            f"unknown search backend {backend!r}; expected 'auto' or one of "
            f"{SEARCH_BACKENDS}"
        )
    return backend


def nearest_hit(
    o: jax.Array,
    d: jax.Array,
    scene: Scene,
    backend: str = "auto",
    tri_chunk: int = 512,
    alive: jax.Array | None = None,
) -> HitRef:
    """Closest-hit search over the whole scene → ``HitRef`` (indices only).

    ``backend``: ``"xla"`` (chunked scan, runs anywhere), ``"triton"`` (the
    fused GPU kernel of ``search_triton.py``), ``"triton-interpret"`` (that
    kernel in the Pallas interpreter, for tests) or ``"auto"`` (see
    :func:`resolve_backend`). Every backend returns the same winners.

    ``alive``: optional bool ``[R]`` wavefront mask — lanes marked dead may
    receive arbitrary miss results (the kernel skips all-dead ray blocks;
    the masked integrator never reads dead lanes' hits).
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene_ng = jax.lax.stop_gradient(scene)
    backend = resolve_backend(backend)

    axis = scene.shard_axis
    if scene_ng.triangles.count == 0:  # sphere-only scene: no triangle pass
        tri_dst = jnp.full(o.shape[:1], MISS_DST, jnp.float32)
        tri_idx = jnp.full(o.shape[:1], -1, jnp.int32)
    elif backend == "xla":
        tri_dst, tri_idx = _search_triangles_xla(
            o, d, scene_ng.triangles, chunk=tri_chunk
        )
    else:
        tri_dst, tri_idx = search_triangles_triton(
            o, d, scene_ng.triangles, alive,
            interpret=backend == "triton-interpret",
        )

    if axis is not None and scene_ng.triangles.count > 0:
        # Block-sharded scene: each device searched its own contiguous
        # original-order triangle shard. Globalize the local indices, then
        # fold the per-shard winners with the (dst, original idx)
        # lexicographic rule — min over a partition of the scan order is
        # min over the whole order, so the merged result is bit-identical
        # to a whole-scene search (C tie semantics included).
        lo = jax.lax.axis_index(axis).astype(jnp.int32) * jnp.int32(
            scene_ng.triangles.count
        )
        tri_idx = jnp.where(tri_dst < MISS_DST, tri_idx + lo, tri_idx)
        d_all = jax.lax.all_gather(tri_dst, axis)  # (n, R)
        i_all = jax.lax.all_gather(tri_idx, axis)
        tri_dst, tri_idx = d_all[0], i_all[0]
        for k in range(1, d_all.shape[0]):
            dk, ik = d_all[k], i_all[k]
            take = (dk < tri_dst) | (
                (dk == tri_dst) & (ik >= 0) & (ik < tri_idx)
            )
            tri_dst = jnp.where(take, dk, tri_dst)
            tri_idx = jnp.where(take, ik, tri_idx)

    if scene.n_spheres > 0:
        sph_dst, sph_idx = _search_spheres(o, d, scene_ng.spheres)
    else:
        sph_dst = jnp.full(o.shape[:1], MISS_DST, jnp.float32)
        sph_idx = jnp.full(o.shape[:1], -1, jnp.int32)

    # Triangles are scanned after spheres in the C loop, so they win only on
    # strictly smaller distance (``raytracing.c:229-237``).
    is_tri = tri_dst < sph_dst
    best = jnp.where(is_tri, tri_dst, sph_dst)
    idx = jnp.where(is_tri, tri_idx, sph_idx)
    hit = best < MISS_DST
    return HitRef(hit=hit, is_tri=is_tri, idx=jnp.where(hit, idx, -1))


# ----------------------------------------------------------------------------
# Resolve: differentiable recompute of the winning primitive's geometry.
# ----------------------------------------------------------------------------


# Minimum padded triangle count at which ``auto`` switches the resolve to
# the Morton-permuted table: the permuted gather pays only once the
# original-order table is too large for nearby winners to share cache
# lines. Not yet measured on the GPU.
PERM_RESOLVE_MIN_T = 500_000


def triangle_table(tris: Triangles) -> jax.Array:
    """(T, 17) packed resolve rows: A, B, C, N, albedo, emission, smooth."""
    return jnp.concatenate(
        [
            tris.a, tris.b, tris.c, tris.normal, tris.albedo,
            tris.emission[:, None], tris.smoothness[:, None],
        ],
        axis=1,
    )


def sphere_table(sph: Spheres) -> jax.Array:
    """(S, 9) packed resolve rows: center, radius, albedo, emission, smooth."""
    return jnp.concatenate(
        [
            sph.center, sph.radius[:, None], sph.albedo,
            sph.emission[:, None], sph.smoothness[:, None],
        ],
        axis=1,
    )


def with_perm_resolve(scene: Scene) -> Scene:
    """Attach the Morton-permuted resolve table (locality-sorted gathers).

    Winners of nearby rays are spatially near, hence Morton-near, hence
    scattered across the original-order table but CONTIGUOUS in the
    accel's permuted order.
    This builds the (T, 17) table permuted into accel order — IN TRACE,
    via a differentiable permutation gather of ``scene.triangles``, so
    values are bitwise the originals and vertex/material gradients flow
    unchanged (the permutation is a bijection; its transpose scatter has
    unique indices, so even the gradient bits match the original-order
    path). Called once at integrator entry; every bounce's resolve then
    gathers from the permuted table via the winner's permuted slot
    (``accel.perm_of_orig``). ``RTC_RESOLVE=orig`` disables for A/B.

    No-op (returns ``scene`` unchanged) without an accel carrying
    ``perm_of_orig``, for block-sharded scenes (their resolve combines via
    masked psum over original-order shards), and — under the default
    ``auto`` — for scenes below ``PERM_RESOLVE_MIN_T``: the permuted
    gather can only win when the table is big enough that original-order
    rows thrash; below that the slot indirection is pure cost.
    ``RTC_RESOLVE=perm|orig`` forces either side for A/B.
    """
    import os

    mode = os.environ.get("RTC_RESOLVE", "auto")
    assert mode in ("auto", "perm", "orig"), (
        f"RTC_RESOLVE={mode!r}: expected 'auto', 'perm' or 'orig'"
    )
    accel = scene.accel
    if (
        mode == "orig"
        or (mode == "auto" and scene.triangles.count < PERM_RESOLVE_MIN_T)
        or accel is None
        or getattr(accel, "perm_of_orig", None) is None
        or scene.shard_axis is not None
        or scene.triangles.count <= 256
        or scene.resolve_perm is not None
    ):
        return scene
    table = triangle_table(scene.triangles)
    # orig_idx maps permuted slot → original id; padding slots carry a huge
    # sentinel, clipped to the last row (gathered garbage, never selected).
    perm_rows = jnp.take(table, scene.accel.orig_idx, axis=0, mode="clip")
    return scene.replace(resolve_perm=perm_rows)


# Tables of at most this many rows are gathered by a one-hot matmul.
ONEHOT_MAX_ROWS = 256


def gather_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """``table[idx]`` for a ``(T, C)`` table: ONE packed row-gather per
    primitive type instead of a gather per field.

    For tables of at most ``ONEHOT_MAX_ROWS`` rows the gather is a one-hot
    matmul instead. At HIGHEST precision a product with 1.0/0.0 selectors
    is exact, so it equals the gather bit for bit (``chip_smoke.py`` checks
    this on the card); a lower precision (TF32 or bf16 passes) would cut
    the gathered geometry's mantissa. Not yet timed against the gather on
    the GPU; its traffic scales as R x T.
    """
    t = table.shape[0]
    if t > ONEHOT_MAX_ROWS:
        return jnp.take(table, idx, axis=0)
    onehot = (
        idx[:, None] == jnp.arange(t, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)
    return jax.lax.dot_general(
        onehot, table, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def resolve_hit(o: jax.Array, d: jax.Array, ref: HitRef, scene: Scene) -> Hit:
    """Recompute (dst, point, normal, material) for the winning primitive.

    The index/flags in ``ref`` are discrete (constant under differentiation);
    geometry and materials are gathered from ``scene`` and the distance is
    recomputed with the same formulas as the search, so ``jax.grad`` of any
    function of the output reaches vertex positions, normals, sphere
    parameters, and materials.
    """
    tri_sel = ref.hit & ref.is_tri
    sph_sel = ref.hit & ~ref.is_tri
    # Branch-local gather indices: a lane that won a TRIANGLE must not use its
    # triangle index into the sphere arrays (it could land on a radius-0
    # padding sphere, whose 1/radius terms poison the backward pass with
    # 0 * inf = NaN), and vice versa. Non-selected lanes gather slot 0.
    tri_idx = jnp.where(tri_sel, ref.idx, 0)
    sph_idx = jnp.where(sph_sel, ref.idx, 0)

    tris, sph = scene.triangles, scene.spheres

    if tris.count:
        if scene.resolve_perm is not None and scene.shard_axis is None:
            # Locality-sorted resolve: gather the winner's row
            # from the Morton-permuted table attached by
            # ``with_perm_resolve`` — same bits, near-sequential rows for
            # coherent rays. The (R,) slot map is a 4-byte/ray gather vs
            # the 68-byte rows it localizes.
            slot = jnp.take(
                scene.accel.perm_of_orig, tri_idx, axis=0, mode="clip"
            )
            tri_rows = jnp.take(scene.resolve_perm, slot, axis=0)
        elif scene.shard_axis is None:
            tri_table = triangle_table(tris)  # (T, 17)
            tri_rows = gather_rows(tri_table, tri_idx)  # (R, 17)
        else:
            # Block-sharded: the winning GLOBAL index lives in
            # exactly one device's original-order shard. Gather locally for
            # the lanes this shard owns, zero the rest, and psum over the
            # axis — the sum is winner_rows + zeros, so every device ends
            # with the full payload (values equal to the replicated gather;
            # only inert zero-signs can differ, which no downstream op
            # exposes — divisions are all where-guarded).
            axis = scene.shard_axis
            lo = jax.lax.axis_index(axis).astype(jnp.int32) * jnp.int32(
                tris.count
            )
            mine = tri_sel & (tri_idx >= lo) & (tri_idx < lo + tris.count)
            local_idx = jnp.where(mine, tri_idx - lo, 0)
            tri_rows = jnp.where(
                mine[:, None], gather_rows(triangle_table(tris), local_idx), 0.0
            )
            tri_rows = jax.lax.psum(tri_rows, axis)
    else:  # sphere-only scene: no lane ever selects a triangle
        tri_rows = jnp.zeros((o.shape[0], 17), jnp.float32)
        # Degenerate all-zero rows would divide by det=0 below; the EPSILON
        # guard already substitutes 1.0, keeping both passes finite.

    # Triangle recompute (unconditional MT distance along the gathered tri).
    a = tri_rows[:, 0:3]
    b = tri_rows[:, 3:6]
    c = tri_rows[:, 6:9]
    ab = b - a
    ac = c - a
    h = jnp.cross(d, ac)
    det = _dot(ab, h)
    # Guard at the same EPSILON the search rejects at: any WINNING triangle has
    # |det| >= EPSILON, so this never alters a selected lane, and it keeps
    # non-selected lanes (slot-0 gathers) finite in both passes (a 1e-20 guard
    # lets near-parallel gathers produce inf, which NaNs the backward via the
    # zero-cotangent where-branches).
    inv_det = 1.0 / jnp.where(jnp.abs(det) < EPSILON, 1.0, det)
    q = jnp.cross(o - a, ab)
    tri_dst = _dot(ac, q) * inv_det
    tri_normal = tri_rows[:, 9:12]

    if sph.count:
        sph_rows = gather_rows(sphere_table(sph), sph_idx)  # (R, 9)

    # Sphere recompute. Slot-0 gathers on non-sphere lanes may still see a
    # radius-0 padding sphere (all-padding scene); guard the divisions so the
    # non-selected branch stays finite in both passes.
    center = sph_rows[:, 0:3] if sph.count else jnp.zeros_like(o)
    radius = sph_rows[:, 3] if sph.count else jnp.ones(o.shape[:1])
    safe_radius = jnp.where(radius > 0.0, radius, 1.0)
    offset = o - center
    bq = _dot(offset, d)
    delta = bq * bq - (_dot(offset, offset) - safe_radius * safe_radius)
    sq = jnp.sqrt(jnp.maximum(delta, 1e-20))
    sph_dst = jnp.where(-bq - sq < EPSILON, -bq + sq, -bq - sq)

    dst = jnp.where(tri_sel, tri_dst, jnp.where(sph_sel, sph_dst, MISS_DST))
    point = o + d * dst[:, None]  # computed even on miss, as the C code does
    sph_normal = (point - center) / safe_radius[:, None]
    normal = jnp.where(tri_sel[:, None], tri_normal, sph_normal)
    normal = jnp.where(ref.hit[:, None], normal, 0.0)

    sel3 = tri_sel[:, None]
    albedo = jnp.where(
        sel3,
        tri_rows[:, 12:15],
        sph_rows[:, 4:7] if sph.count else 0.0,
    )
    emission = jnp.where(
        tri_sel,
        tri_rows[:, 15],
        sph_rows[:, 7] if sph.count else 0.0,
    )
    smoothness = jnp.where(
        tri_sel,
        tri_rows[:, 16],
        sph_rows[:, 8] if sph.count else 0.0,
    )
    zero3 = jnp.zeros_like(albedo)
    return Hit(
        hit=ref.hit,
        dst=dst,
        point=point,
        normal=normal,
        albedo=jnp.where(ref.hit[:, None], albedo, zero3),
        emission=jnp.where(ref.hit, emission, 0.0),
        smoothness=jnp.where(ref.hit, smoothness, 0.0),
    )


@partial(jax.jit, static_argnames=("backend",))
def intersect(o, d, scene: Scene, backend: str = "auto") -> Hit:
    """Convenience: search + resolve in one call."""
    return resolve_hit(o, d, nearest_hit(o, d, scene, backend=backend), scene)
