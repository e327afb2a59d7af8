"""Path-tracing integrator: the C bounce loop as masked ``lax.scan`` dataflow.

Reference ``calcColor`` (``raytracing.c:262-296``), one Monte-Carlo sample:
up to ``max_bounce`` iterations; on hit the ray scatters with
``lerp(normalize(normal + random_unit), reflect(dir, normal), smoothness)``
(cosine-weighted diffuse vs mirror specular), emission is accumulated weighted
by the PRE-update throughput, throughput is multiplied by albedo, then Russian
roulette on ``p = max(throughput)`` terminates with renormalization ``×1/p``
(``raytracing.c:283-287``). On miss the environment light is added and the
path ends.

Here every early ``break`` becomes an ``alive`` mask: all lanes march through
the same ``lax.scan``, dead lanes simply stop contributing. Russian roulette
under masking preserves the same expectation as the C loop (the ``1/p``
renormalization makes the estimator unbiased either way).

The scan also counts traced rays (bounces actually taken) so benchmarks can
report honest rays/s rather than primary-sample counts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracingc_tpu import rng
from raytracingc_tpu.ops.env_light import environment_light
from raytracingc_tpu.ops.intersect import (
    nearest_hit,
    resolve_hit,
    with_perm_resolve,
)
from raytracingc_tpu.scene.types import Scene
from raytracingc_tpu.utils.pytree import pytree_node

_LO_BITS = 16


@pytree_node
class RayCount:
    """An exact count of traced rays: ``hi * 2**16 + lo``, two uint32 words.

    A frame traces more rays than float32 counts exactly (2**24), and a
    float32 sum rounds by amounts that depend on the order of its terms, so
    a chunked and a sharded render of one frame would report different
    totals. This count is exact up to 2**48 rays and order-independent;
    ``value()`` (or ``float()``) rounds it to float32 once.
    """

    hi: jax.Array  # uint32
    lo: jax.Array  # uint32, < 2**16 after every operation

    @classmethod
    def of(cls, n) -> "RayCount":
        """From a non-negative int32 count (e.g. live lanes of one pass)."""
        n = jnp.asarray(n).astype(jnp.uint32)
        return cls(hi=n >> _LO_BITS, lo=n & ((1 << _LO_BITS) - 1))

    @classmethod
    def zero(cls) -> "RayCount":
        return cls.of(jnp.int32(0))

    def _carried(self) -> "RayCount":
        return RayCount(hi=self.hi + (self.lo >> _LO_BITS),
                        lo=self.lo & ((1 << _LO_BITS) - 1))

    def __add__(self, other: "RayCount") -> "RayCount":
        return RayCount(hi=self.hi + other.hi, lo=self.lo + other.lo)._carried()

    def times(self, k: int) -> "RayCount":
        """``self * k`` for a static ``k >= 0``, by doubling."""
        out = RayCount.zero()
        acc = self
        while k:
            if k & 1:
                out = out + acc
            acc, k = acc + acc, k >> 1
        return out

    def sum(self) -> "RayCount":
        """Total over a leading axis (at most 2**16 terms, e.g. chunks)."""
        return RayCount(hi=jnp.sum(self.hi), lo=jnp.sum(self.lo))._carried()

    def psum(self, axis_name) -> "RayCount":
        """Total over mesh axes (at most 2**16 devices)."""
        return RayCount(hi=jax.lax.psum(self.hi, axis_name),
                        lo=jax.lax.psum(self.lo, axis_name))._carried()

    def value(self) -> jax.Array:
        """The count as float32: exact below 2**24, else rounded once."""
        return (self.hi.astype(jnp.float32) * jnp.float32(1 << _LO_BITS)
                + self.lo.astype(jnp.float32))

    def __float__(self) -> float:
        return float(self.value())


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _reflect(d: jax.Array, n: jax.Array) -> jax.Array:
    """Mirror reflection (``moremath.c:79-82``)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def trace_paths(
    origins: jax.Array,  # [R, 3]
    dirs: jax.Array,  # [R, 3]
    rng_state: jax.Array,  # uint32 [R]
    scene: Scene,
    max_bounce: int,
    backend: str = "auto",
    active: jax.Array | None = None,  # bool [R] — padding lanes pass False
    early_exit: bool = False,
    first_hit=None,  # optional precomputed Hit for bounce 0 (primary cache)
    compact: bool = False,  # tiered live-lane compaction (see docstring)
    throughput0: jax.Array | None = None,  # [R, 3] initial path throughput
) -> tuple[jax.Array, RayCount]:
    """Trace one sample per ray. Returns ``(radiance [R, 3], rays_traced)``.

    ``rays_traced`` is the total number of scene intersections actually
    performed by live lanes (for throughput accounting). Lanes with
    ``active=False`` (shape padding) are dead from the start: zero radiance,
    zero count.

    ``early_exit=True`` runs the bounce loop as a ``lax.while_loop`` that
    stops as soon as every lane is dead — the analog of the C integrator's
    per-ray ``break`` (``raytracing.c:268-292``), recovered at batch
    granularity. Identical output; NOT reverse-differentiable (use the
    default scan when gradients are needed).

    ``first_hit``: a precomputed ``resolve_hit`` result for (origins, dirs) —
    primary rays are deterministic per pixel, so the accumulator computes the
    first intersection ONCE and shares it across all spp samples (the C code
    redundantly recomputes the identical intersection every sample,
    ``main.c:98-99`` → ``raytracing.c:270``). Bit-identical results.
    """
    r = origins.shape[0]
    alive0 = jnp.ones((r,), bool) if active is None else active
    thr0 = (
        jnp.ones((r, 3), jnp.float32) if throughput0 is None else throughput0
    )
    carry = (
        origins,
        dirs,
        thr0,  # throughput ("rayColor")
        jnp.zeros((r, 3), jnp.float32),  # accumulated radiance
        alive0,  # alive mask
        rng_state,
        RayCount.zero(),  # traced-ray counter
    )

    def bounce_with_hit(carry, hit):
        pos, d, throughput, light, alive, state, count = carry
        count = count + RayCount.of(jnp.sum(alive, dtype=jnp.int32))

        # Scatter (``raytracing.c:274-277``). Drawing random numbers for dead
        # lanes is harmless: each lane owns an independent counter stream.
        state, unit = rng.next_unit_vector(state)
        diffuse = _normalize(hit.normal + unit)
        specular = _reflect(d, hit.normal)
        smooth = hit.smoothness[:, None]
        new_dir = (1.0 - smooth) * diffuse + smooth * specular

        # Emission weighted by PRE-update throughput, then albedo multiply
        # (ordering matters — ``raytracing.c:279-281``).
        live_hit = alive & hit.hit
        emitted = hit.albedo * hit.emission[:, None]
        light = light + jnp.where(live_hit[:, None], emitted * throughput, 0.0)
        new_throughput = throughput * hit.albedo

        # Russian roulette (``raytracing.c:283-287``): survive iff p >= u.
        # The 1/p renorm is guarded with where (not a tiny clamp): lanes with
        # p == 0 (miss resolves on dead/miss lanes give zero albedo) would
        # otherwise put ~1e20 partials into the VJP and overflow to NaN.
        state, u_rr = rng.next_uniform(state)
        p = jnp.max(new_throughput, axis=-1)
        survive = p >= u_rr
        safe_p = jnp.where(p > 0.0, p, 1.0)
        new_throughput = new_throughput / safe_p[:, None]

        # Miss: add environment light and terminate (``raytracing.c:289-292``).
        live_miss = alive & ~hit.hit
        env = environment_light(d, scene.env)
        light = light + jnp.where(live_miss[:, None], env * throughput, 0.0)

        throughput = jnp.where(live_hit[:, None], new_throughput, throughput)
        pos = jnp.where(live_hit[:, None], hit.point, pos)
        d = jnp.where(live_hit[:, None], new_dir, d)
        alive = live_hit & survive
        return (pos, d, throughput, light, alive, state, count), None

    def bounce(carry, _):
        pos, d, _, _, alive, _, _ = carry
        ref = nearest_hit(pos, d, scene, backend=backend, alive=alive)
        hit = resolve_hit(pos, d, ref, scene)
        return bounce_with_hit(carry, hit)

    remaining = max_bounce
    if first_hit is not None and max_bounce >= 1:
        carry, _ = bounce_with_hit(carry, first_hit)
        remaining = max_bounce - 1

    if early_exit:
        # Tier CASCADE: run the bounce while_loop at full width until the
        # live count fits the next (4x smaller) buffer, then gather the live
        # lanes forward ONCE and continue at that width; repeat down the
        # ladder. Each lane's accumulated radiance is scattered back to its
        # original slot once per tier exit (deeper tiers overwrite — the
        # deepest value is the lane's final one).
        #
        # State moves only at tier transitions (≤3 per chunk per sample),
        # not on every bounce, and dead lanes' state is simply abandoned. Bit-identical results (lanes are
        # independent, counter-based RNG rides along).
        #
        # A tier exit can also happen because the bounce budget or all lanes
        # died — then the deeper tiers' loops run zero iterations and the
        # final scatters are no-ops on already-final radiance.
        sizes = [r]
        if compact:
            sizes += [k for k in (r // 4, r // 16, r // 64)
                      if k >= 1024 and r % k == 0]

        light_full = jnp.zeros((r, 3), jnp.float32)
        orig = jnp.arange(r, dtype=jnp.int32)  # buffer slot -> original lane
        i = jnp.int32(0)
        buf = carry

        for t, size in enumerate(sizes):
            next_size = sizes[t + 1] if t + 1 < len(sizes) else 0

            def cond(s, next_size=next_size):
                i, c = s
                n_alive = jnp.sum(c[4].astype(jnp.int32))
                return (i < remaining) & (n_alive > next_size)

            def body(s):
                i, c = s
                return i + 1, bounce(c, None)[0]

            i, buf = jax.lax.while_loop(cond, body, (i, buf))
            light_t = buf[3]
            if t == 0:
                light_full = light_t  # identity mapping at full width
            else:
                light_full = light_full.at[orig].set(light_t)

            if t + 1 < len(sizes):
                k = sizes[t + 1]
                pos_b, d_b, thr_b, light_b, alive_b, state_b, count_b = buf
                sel = _alive_front_perm(alive_b)[:k]
                # One packed row-gather instead of 7 parallel small gathers.
                # The non-f32 columns ride along bitcast: exact data
                # movement.
                bc = jax.lax.bitcast_convert_type
                packed = jnp.concatenate(
                    [
                        pos_b, d_b, thr_b, light_b,
                        alive_b[:, None].astype(jnp.float32),
                        bc(state_b, jnp.float32)[:, None],
                        bc(orig, jnp.float32)[:, None],
                    ],
                    axis=1,
                )
                packed = jnp.take(packed, sel, axis=0)
                buf = (
                    packed[:, 0:3], packed[:, 3:6], packed[:, 6:9],
                    packed[:, 9:12], packed[:, 12] > 0.5,
                    bc(packed[:, 13], jnp.uint32), count_b,
                )
                orig = bc(packed[:, 14], jnp.int32)

        # NOTE: this path is not reverse-differentiable (lax.while_loop has
        # no transpose rule; jax raises a clear error naming while_loop).
        # Use early_exit=False (the fixed-length masked scan) for gradients.
        # Forward-mode (jvp) works fine through the while_loops.
        return light_full, buf[6]

    carry, _ = jax.lax.scan(bounce, carry, None, length=remaining)
    _, _, _, light, _, _, count = carry
    return light, count


@partial(
    jax.jit,
    static_argnames=(
        "max_bounce", "spp", "backend", "early_exit", "sample_batch",
        "compact", "sample_group",
    ),
)
def trace_accumulate(
    origins: jax.Array,
    dirs: jax.Array,
    scene: Scene,
    ray_ids: jax.Array,  # uint32/int32 [R] — global pixel ids for RNG streams
    seed: int,
    spp: int,
    max_bounce: int,
    backend: str = "auto",
    sample_offset: jax.Array | int = 0,
    active: jax.Array | None = None,
    early_exit: bool = False,
    sample_batch: int | str = 1,
    compact: bool = True,
    sample_group: int | str = 1,
) -> tuple[jax.Array, RayCount]:
    """Average ``spp`` samples per ray (``main.c:98-99``'s 1/N accumulation).
    Returns ``(radiance [R, 3], rays_traced)``.

    Mode matrix (``early_exit``, ``compact``):

    * ``(True, True)`` — production forward: hit-front accumulation +
      while_loop tier cascade. Fastest; NOT reverse-differentiable.
    * ``(False, True)`` — the DEFAULT here: differentiable fast forward.
      Same hit-front selection and ``light0*spp + sum(rest)`` association
      (bit-identical forward values to the production path), but the
      continuation is a fixed-length ``lax.scan`` in the compacted domain —
      reverse-differentiable while still skipping all primary-miss lanes.
    * ``(False, False)`` — plain full-width fixed-length scan (the reference
      baseline semantics; associates ``sum_s(light0 + rest_s)``). Slow;
      kept as the independent oracle the equivalence tests compare against.

    Each sample gets an independent RNG stream keyed by
    (seed, ray_id, sample_id) — so per-lane radiance values are identical
    however the samples are scheduled. Samples are processed
    ``sample_batch`` at a time as one widened ray batch (lane ``k*R + i`` is
    sample ``k`` of ray ``i``). Wider batches amortize pass overheads but
    lose per-sample early-exit granularity (a batch's bounce loop runs until
    ALL its samples die). Default 1; the knob exists for workloads with
    heavier per-pass overhead (tiny chunks, many chunks).
    ``"auto"`` picks the largest divisor of ``spp`` up to 8.

    ``sample_offset`` shifts the sample-id range — the hook for sharding the
    sample axis over devices: device ``k`` passes ``offset = k * spp`` and the
    per-device means are ``pmean``-combined: the same per-sample radiance
    and ray count as a single device tracing ``n * spp`` samples, with the
    sum re-associated (3.2e-7 of the radiance at 1080p on four H100s).
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    r = origins.shape[0]
    seed_arr = jnp.uint32(seed)
    offset = jnp.asarray(sample_offset, jnp.uint32)
    # Loud validation (parity with sample_batch below): a sample_group that
    # cannot apply must not be silently ignored — the caller would measure
    # g=1 believing g ran.
    if sample_group != 1 and sample_group != "auto":
        if spp % int(sample_group) != 0:
            raise ValueError(
                f"sample_group={sample_group} must divide spp={spp}"
            )
        if not (early_exit or compact):
            raise ValueError(
                "sample_group>1 requires the hit-front accumulator "
                "(early_exit=True or compact=True); the plain fixed-length "
                "scan ignores it"
            )
        if sample_batch != 1:
            raise ValueError(
                "sample_group and sample_batch>1 are mutually exclusive "
                "(the widened sample_batch path bypasses the hit-front "
                "accumulator)"
            )
    if sample_batch == "auto":
        sample_batch = next(k for k in (8, 4, 2, 1) if spp % k == 0)
    assert spp % sample_batch == 0, (spp, sample_batch)
    n_batches = spp // sample_batch

    # Locality-sorted resolve: attach the Morton-permuted resolve
    # table once; every bounce's resolve gathers from it (same bits, same
    # gradients — see ``with_perm_resolve``).
    scene = with_perm_resolve(scene)

    # Primary-hit cache: the bounce-0 intersection is identical for every
    # sample of a pixel (deterministic primary ray), so search+resolve once
    # and share the Hit across the sample scan. The count accounting below
    # still charges one traced ray per sample per live lane, as the C code
    # actually performs them (``raytracing.c:270``).
    if max_bounce >= 1:
        ref0 = nearest_hit(origins, dirs, scene, backend=backend, alive=active)
        hit0 = resolve_hit(origins, dirs, ref0, scene)
    else:
        hit0 = None

    if sample_batch > 1:
        widen = lambda x: jnp.tile(x, (sample_batch,) + (1,) * (x.ndim - 1))
        origins_w, dirs_w = widen(origins), widen(dirs)
        ray_ids_w = jnp.tile(ray_ids, (sample_batch,))
        active_w = widen(active) if active is not None else None
        hit0_w = (
            jax.tree_util.tree_map(widen, hit0) if hit0 is not None else None
        )

        def batch(carry, b):
            acc, total = carry
            sid = b * jnp.uint32(sample_batch) + jnp.arange(
                sample_batch, dtype=jnp.uint32
            )
            sid_w = jnp.repeat(sid, r) + offset
            state = rng.stream_init(seed_arr, ray_ids_w, sid_w)
            radiance, count = trace_paths(
                origins_w, dirs_w, state, scene, max_bounce, backend=backend,
                active=active_w, early_exit=early_exit, first_hit=hit0_w,
                compact=compact,
            )
            acc = acc + jnp.sum(radiance.reshape(sample_batch, r, 3), axis=0)
            return (acc, total + count), None

        init = (jnp.zeros((r, 3), jnp.float32), RayCount.zero())
        (acc, total), _ = jax.lax.scan(
            init=init, f=batch, xs=jnp.arange(n_batches, dtype=jnp.uint32)
        )
        return acc / jnp.float32(spp), total

    if (early_exit or compact) and max_bounce >= 1:
        # Entry-width ladder: tightest first. A chunk whose primary rays
        # mostly miss (open scenes) enters at R/8 — halving the per-sample
        # search width and the cascade-transition cost vs a fixed R/4
        # entry.
        #
        # ``early_exit=False, compact=True`` is the DIFFERENTIABLE fast
        # forward: the same hit-front structure — the
        # per-chunk compaction permutation depends only on the deterministic
        # (stop-gradient) ``hit0.hit``, and every gather/scatter here is
        # reverse-differentiable — but the per-sample continuation runs as a
        # fixed-length ``lax.scan`` in the compacted k0 domain instead of
        # the while_loop cascade. Gradients flow while all primary-miss
        # lanes are skipped; association identical to the production path
        # (``light0*spp + sum(rest)``).
        k0s = [
            k for k in (r // 8, r // 4)
            if compact and k >= 1024 and r % k == 0
        ]
        if sample_group == "auto":
            # Largest divisor of spp that keeps the batched R/8-entry width
            # near 64k rays (branch-independent: g is a
            # function of (spp, r) only, so every switch branch and width
            # adds the SAME sample slices in the same order).
            cap = max(65536 // max(r // 8, 1), 1)
            sample_group = next(
                g for g in range(min(cap, spp), 0, -1) if spp % g == 0
            )
        return _hit_front_accumulate(
            origins, dirs, scene, ray_ids, seed_arr, offset, spp,
            max_bounce, backend, active, hit0, k0s, compact,
            sample_group=sample_group, early_exit=early_exit,
        )

    def sample(carry, sample_id):
        acc, total = carry
        state = rng.stream_init(seed_arr, ray_ids, sample_id)
        radiance, count = trace_paths(
            origins, dirs, state, scene, max_bounce, backend=backend,
            active=active, early_exit=early_exit, first_hit=hit0,
            compact=compact,
        )
        return (acc + radiance, total + count), None

    init = (jnp.zeros_like(origins), RayCount.zero())
    (acc, total), _ = jax.lax.scan(
        init=init, f=sample, xs=jnp.arange(spp, dtype=jnp.uint32) + offset
    )
    return acc / jnp.float32(spp), total


def _front_pack(mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Stable front-packing permutation and its inverse.

    ``perm[j]`` is the index of the j-th True lane for ``j < sum(mask)``,
    then the False lanes in order — argsort-free via prefix sums; ``dest``
    is the inverse (``dest[i]`` = lane ``i``'s packed slot). The same idiom
    serves the tier-cascade transitions and the hit-front selection; both
    compaction bit-identity arguments rest on this being stable.
    """
    n = mask.shape[0]
    n_true = jnp.sum(mask.astype(jnp.int32))
    posi = jnp.cumsum(mask.astype(jnp.int32)) - 1
    negi = jnp.cumsum((~mask).astype(jnp.int32)) - 1 + n_true
    dest = jnp.where(mask, posi, negi)
    perm = jnp.zeros((n,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    return perm, dest


def _alive_front_perm(mask: jax.Array) -> jax.Array:
    """Front-packing permutation only (see :func:`_front_pack`)."""
    return _front_pack(mask)[0]


def _hit_front_accumulate(
    origins, dirs, scene, ray_ids, seed_arr, offset, spp,
    max_bounce, backend, active, hit0, k0s, compact, sample_group=1,
    early_exit=True,
):
    """Sample accumulation with per-CHUNK hit-front compaction.

    Profiling exposed that the per-SAMPLE tier transition (a full-width
    permutation scatter + 7 gathers) dominated the bench even in the
    cascade design. But bounce 0 is special: the primary hit mask and hit
    geometry are DETERMINISTIC per pixel, so

    * the bounce-0 radiance (emission for hit lanes, environment light for
      miss lanes, throughput = 1) is identical for every sample — compute it
      once, weight by ``spp``;
    * the compaction selection (pack hit lanes to the front) depends only on
      ``hit0.hit`` — build it once per chunk and hoist ALL full-width
      gathers out of the sample loop;
    * each sample's stochastic continuation (scatter direction, roulette,
      bounces 1..N-1) runs natively in the k0-wide compact domain via
      :func:`trace_paths` (which cascades further down /4 /16 /64), and the
      per-sample radiance accumulates compact; ONE scatter-add per chunk
      maps it back.

    ``k0s`` is an entry-width ladder (e.g. ``[R/8, R/4]``): a
    ``lax.switch`` picks the tightest width the chunk's hit count fits.
    Chunks whose hit count exceeds every ladder entry (e.g. fully
    geometry-covered chunks, where compaction cannot help) take a
    FULL-WIDTH branch of the same structure; an empty ladder (small
    chunks, or ``compact=False``) uses the full-width branch alone.

    Both branches compute per-lane radiance as
    ``light0 * spp + sum_s(rest_s)`` with identical per-lane arithmetic
    (compaction itself is bit-identical), so the result does NOT depend on
    which branch ran — which keeps the sharded == single-device invariant
    EXACT regardless of per-shard chunk statistics. Only the plain
    fixed-length scan path (``early_exit=False, compact=False``) associates
    differently (``sum_s(light0 + rest_s)``), agreeing to float
    re-association.

    ``early_exit=False`` (with ``compact=True``) is the DIFFERENTIABLE fast
    forward: the same hit-front selection (the permutation depends only on
    the deterministic ``hit0.hit`` — a boolean, so its "gradient" is the
    standard visibility-frozen subgradient this repo already pins for
    vertices), but each sample's continuation runs bounces 1..N-1 as a
    fixed-length ``lax.scan`` in the compacted k0 domain — every op on the
    path (row-gather, switch, scan, inverse-permutation gather) is
    reverse-differentiable, while all primary-miss lanes are skipped
    exactly as in the production path.
    """
    r = origins.shape[0]
    act = jnp.ones((r,), bool) if active is None else active
    hitm = hit0.hit & act
    n_hit = jnp.sum(hitm.astype(jnp.int32))

    # Deterministic bounce-0 radiance (same for every sample): emission
    # weighted by the initial throughput 1 on hit lanes; environment light
    # on miss lanes (``raytracing.c:279-281,289-292``).
    emitted = hit0.albedo * hit0.emission[:, None]
    env = environment_light(dirs, scene.env)
    light0 = (
        jnp.where(hitm[:, None], emitted, 0.0)
        + jnp.where((act & ~hit0.hit)[:, None], env, 0.0)
    )
    count0 = RayCount.of(jnp.sum(act, dtype=jnp.int32)).times(spp)

    sample_ids = jnp.arange(spp, dtype=jnp.uint32) + offset

    def continuation(point, normal, albedo, smooth, d0, ids, valid, width):
        """Per-sample bounces 1..N-1 from the (possibly compacted) hit set.

        ``sample_group`` (static, divides spp) traces that many samples as
        ONE widened batch — lane ``k * width + i`` is sample ``k`` of hit
        slot ``i`` — so the per-bounce search/shade passes run at g× the
        width with 1/g of the launches and inter-bounce XLA ops. Per-lane
        arithmetic is g-independent (counter RNG, lane-independent math)
        and the group's slices are added into the accumulator SEQUENTIALLY
        in sample order, so the association never changes; results agree
        with g=1 within the repo-wide ~1-ulp XLA fusion-context wobble
        (different g = different program shapes; measured ≤6e-8) with
        traced-ray counts exactly equal.
        """
        smooth = smooth[:, None]
        # Post-bounce-0 throughput is deterministic: albedo / p with
        # p = max(albedo) (the roulette renorm); only SURVIVAL is random.
        p = jnp.max(albedo, axis=-1)
        thr = albedo / jnp.where(p > 0.0, p, 1.0)[:, None]
        spec = _reflect(d0, normal)

        g = sample_group if spp % sample_group == 0 else 1
        if g > 1:
            widen = lambda x: jnp.tile(x, (g,) + (1,) * (x.ndim - 1))
            point_b, normal_b, spec_b = widen(point), widen(normal), widen(spec)
            smooth_b, thr_b = widen(smooth), widen(thr)
            p_b, valid_b, ids_b = widen(p), widen(valid), widen(ids)

            def group(carry, sids):  # sids: (g,) sample ids in order
                acc, total = carry
                sid_b = jnp.repeat(sids, width)
                state = rng.stream_init(seed_arr, ids_b, sid_b)
                state, unit = rng.next_unit_vector(state)
                diffuse = _normalize(normal_b + unit)
                new_dir = (1.0 - smooth_b) * diffuse + smooth_b * spec_b
                state, u_rr = rng.next_uniform(state)
                alive1 = valid_b & (p_b >= u_rr)
                light_b, cnt = trace_paths(
                    point_b, new_dir, state, scene, max_bounce - 1,
                    backend=backend, active=alive1, early_exit=early_exit,
                    compact=compact, throughput0=thr_b,
                )
                for k in range(g):  # sequential adds: association == g=1
                    acc = acc + light_b[k * width : (k + 1) * width]
                return (acc, total + cnt), None

            init = (
                jnp.zeros((width, 3), jnp.float32), RayCount.zero()
            )
            (acc, total), _ = jax.lax.scan(
                group, init, sample_ids.reshape(spp // g, g)
            )
            return acc, total

        def sample(carry, sid):
            acc, total = carry
            state = rng.stream_init(seed_arr, ids, sid)
            # Same draw order as ``bounce_with_hit``: 6 for the unit vector,
            # 1 for roulette — per-lane streams match the scan path.
            state, unit = rng.next_unit_vector(state)
            diffuse = _normalize(normal + unit)
            new_dir = (1.0 - smooth) * diffuse + smooth * spec
            state, u_rr = rng.next_uniform(state)
            alive1 = valid & (p >= u_rr)
            light_s, cnt = trace_paths(
                point, new_dir, state, scene, max_bounce - 1,
                backend=backend, active=alive1, early_exit=early_exit,
                compact=compact, throughput0=thr,
            )
            return (acc + light_s, total + cnt), None

        init = (
            jnp.zeros((width, 3), jnp.float32), RayCount.zero()
        )
        (acc, total), _ = jax.lax.scan(sample, init, sample_ids)
        return acc, total

    def full_branch(_):
        acc_r, total = continuation(
            hit0.point, hit0.normal, hit0.albedo, hit0.smoothness,
            dirs, ray_ids, hitm, r,
        )
        return light0 * jnp.float32(spp) + acc_r, total + count0

    if not k0s:
        acc, total = full_branch(None)
        return acc / jnp.float32(spp), total

    def make_compact_branch(k0):
        def compact_branch(_):
            # Hit-front permutation, built ONCE per chunk.
            perm, dest = _front_pack(hitm)
            sel0 = perm[:k0]
            lanes = jnp.arange(k0, dtype=jnp.int32) < n_hit  # valid slots

            # One packed row-gather instead of 6 parallel small gathers
            # (same measured rule as the tier-cascade transition; ray_ids
            # ride along bitcast — exact data movement).
            bc = jax.lax.bitcast_convert_type
            packed = jnp.concatenate(
                [
                    hit0.point, hit0.normal, hit0.albedo,
                    hit0.smoothness[:, None], dirs,
                    bc(ray_ids, jnp.float32)[:, None],
                ],
                axis=1,
            )
            packed = jnp.take(packed, sel0, axis=0)
            acc_c, total = continuation(
                packed[:, 0:3], packed[:, 3:6], packed[:, 6:9],
                packed[:, 9], packed[:, 10:13],
                bc(packed[:, 13], jnp.uint32), lanes, k0,
            )
            # Map-back as a GATHER by the inverse permutation, not a
            # scatter-add (not yet timed against the scatter on the GPU,
            # where scatters can be atomic-free too). Non-hit lanes read
            # masked zeros (slots [n_hit, k0)) or the zero padding
            # (slots >= k0) — adding 0.0 matches the old "never touched"
            # semantics bitwise for the non-negative radiance values here.
            acc_c = jnp.where(lanes[:, None], acc_c, 0.0)
            contrib = jnp.concatenate(
                [acc_c, jnp.zeros((r - k0, 3), jnp.float32)], axis=0
            )[dest]
            return light0 * jnp.float32(spp) + contrib, total + count0

        return compact_branch

    # Switch index: tightest fitting ladder entry, else the full branch.
    branches = [make_compact_branch(k) for k in k0s] + [full_branch]
    idx = jnp.int32(len(k0s))  # default: full
    for t in reversed(range(len(k0s))):
        idx = jnp.where(n_hit <= k0s[t], jnp.int32(t), idx)
    acc, total = jax.lax.switch(idx, branches, None)
    return acc / jnp.float32(spp), total


def trace_debug_bounces(
    origins: jax.Array,
    dirs: jax.Array,
    rng_state: jax.Array,
    scene: Scene,
    max_bounce: int,
    backend: str = "auto",
) -> jax.Array:
    """Bounce-count heatmap (reference ``calcDebugColor``, ``raytracing.c:242-260``).

    Walks the same hit/scatter loop but returns grayscale
    ``bounces / max_bounce`` per ray instead of radiance — the reference's
    (manually wired) render-debug integrator, exposed here as a first-class
    entry point (CLI ``--debug-bounces``). Unlike ``calcColor``, the C debug
    walk has NO Russian roulette (``raytracing.c:242-260`` draws only the
    scatter direction): a path ends only on miss or at ``max_bounce``.
    Returns ``[R, 3]`` in [0, 1].
    """
    scene = with_perm_resolve(scene)
    r = origins.shape[0]
    carry = (
        origins,
        dirs,
        jnp.zeros((r,), jnp.float32),  # bounce counter per lane
        jnp.ones((r,), bool),
        rng_state,
    )

    def bounce(carry, _):
        pos, d, n_bounce, alive, state = carry
        ref = nearest_hit(pos, d, scene, backend=backend, alive=alive)
        hit = resolve_hit(pos, d, ref, scene)

        state, unit = rng.next_unit_vector(state)
        diffuse = _normalize(hit.normal + unit)
        specular = _reflect(d, hit.normal)
        smooth = hit.smoothness[:, None]
        new_dir = (1.0 - smooth) * diffuse + smooth * specular

        live_hit = alive & hit.hit
        n_bounce = n_bounce + live_hit.astype(jnp.float32)

        pos = jnp.where(live_hit[:, None], hit.point, pos)
        d = jnp.where(live_hit[:, None], new_dir, d)
        alive = live_hit
        return (pos, d, n_bounce, alive, state), None

    carry, _ = jax.lax.scan(bounce, carry, None, length=max_bounce)
    _, _, n_bounce, _, _ = carry
    shade = jnp.clip(n_bounce / jnp.float32(max(max_bounce, 1)), 0.0, 1.0)
    return jnp.broadcast_to(shade[:, None], (r, 3))


@partial(jax.jit, static_argnames=("width", "height", "max_bounce", "backend"))
def render_debug(
    scene: Scene,
    camera,
    width: int,
    height: int,
    max_bounce: int,
    seed: int = 0,
    backend: str = "auto",
) -> jax.Array:
    """Full-image bounce heatmap, one sample per pixel → ``[H, W, 3]``."""
    from raytracingc_tpu.camera import primary_rays

    origins, dirs = primary_rays(camera, width, height)
    ray_ids = jnp.arange(width * height, dtype=jnp.uint32)
    state = rng.stream_init(jnp.uint32(seed), ray_ids, 0)
    img = trace_debug_bounces(origins, dirs, state, scene, max_bounce,
                              backend=backend)
    return img.reshape(height, width, 3)
