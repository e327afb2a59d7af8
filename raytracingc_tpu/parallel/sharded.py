"""Sharded rendering and sharded differentiable training steps.

This is the device-mesh form of the reference's parallel executor
(``rowThread`` + pthread spawn/join, ``main.c:81-105,284-303``):

* The pixel axis is sharded over the mesh's ``px`` dimension (the row-cyclic
  analog — disjoint output tiles, zero communication while tracing).
* The sample axis (the reference's sequential 4000-iteration accumulation,
  ``main.c:98-99``) optionally shards over the ``spp`` mesh dimension; the
  per-device sample means are ``pmean``-combined.
* Scene buffers are replicated by default (a few thousand triangles are a
  few hundred KB of f32 SoA); ``scene_sharding="blocks"`` shards them 1/n
  per device instead, for scenes too large to replicate.
* For training, per-shard scene gradients are ``pmean``-reduced over both mesh
  axes inside the step, so the optimizer update is identical on every device —
  pure data parallelism over rays/samples with replicated parameters.

Everything is ``shard_map`` over an explicit ``Mesh``: collectives are
spelled out (``pmean``/``psum``), shardings are named, and the search
kernel runs per-shard without SPMD partitioning hazards.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # JAX >= 0.4.35 exposes shard_map at top level
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.parallel.mesh import make_mesh
from raytracingc_tpu.render.integrator import trace_accumulate
from raytracingc_tpu.scene.types import Scene


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rays(origins, dirs, ray_ids, multiple: int):
    """Pad the ray arrays to a shardable multiple; padding lanes are masked."""
    n = origins.shape[0]
    padded = _round_up(n, multiple)
    active = jnp.arange(padded, dtype=jnp.int32) < n
    if padded == n:
        return origins, dirs, ray_ids, active, n
    pad = padded - n
    origins = jnp.pad(origins, ((0, pad), (0, 0)))
    dirs = jnp.pad(dirs, ((0, pad), (0, 0)))
    dirs = dirs.at[n:, 2].set(1.0)
    ray_ids = jnp.pad(ray_ids, (0, pad))
    return origins, dirs, ray_ids, active, n


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounce", "backend", "mesh", "seed",
        "early_exit", "compact", "sample_group"
    ),
)
def _render_sharded_jit(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int,
    backend: str,
    mesh: Mesh,
    early_exit: bool = True,
    sample_offset: jax.Array | int = 0,
    compact: bool = True,
    sample_group: int | str = 1,
):
    px_size = mesh.shape["px"]
    spp_size = mesh.shape["spp"]
    assert spp % spp_size == 0, f"spp={spp} not divisible by mesh spp={spp_size}"
    spp_per = spp // spp_size
    base_offset = jnp.asarray(sample_offset, jnp.uint32)

    origins, dirs = primary_rays(camera, width, height)
    ray_ids = jnp.arange(width * height, dtype=jnp.uint32)
    origins, dirs, ray_ids, active, n_pix = _pad_rays(
        origins, dirs, ray_ids, px_size
    )

    def shard_fn(scene, o, d, ids, act):
        offset = base_offset + jax.lax.axis_index("spp").astype(
            jnp.uint32
        ) * jnp.uint32(spp_per)
        radiance, count = trace_accumulate(
            o,
            d,
            scene,
            ids,
            seed=seed,
            spp=spp_per,
            max_bounce=max_bounce,
            backend=backend,
            sample_offset=offset,
            active=act,
            early_exit=early_exit,
            compact=compact,
            sample_group=sample_group,
        )
        # Combine the sample-axis partial means; total traced-ray count over
        # the whole mesh (for honest rays/s accounting).
        radiance = jax.lax.pmean(radiance, "spp")
        count = count.psum(("px", "spp"))
        return radiance, count.value()

    radiance, count = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("px"), P("px"), P("px"), P("px")),
        out_specs=(P("px"), P()),
        check_vma=False,
    )(scene, origins, dirs, ray_ids, active)

    image = radiance[:n_pix].reshape(height, width, 3)
    return image, count


def strategy_spp_dim(strategy: str, n_devices: int) -> int:
    """The spp mesh dimension a strategy resolves to on ``n_devices``.

    The SINGLE source of truth for the strategy → mesh-shape mapping —
    ``render_sharded``, ``render_progressive``'s up-front batch validation,
    and ``bench.py``'s BENCH_SHARD all consult it, so the divisibility
    predictions can never drift from the mesh actually built.
    """
    if strategy == "pixels":
        return 1
    if strategy == "samples":
        return n_devices
    if strategy == "both":
        return 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    raise ValueError(f"unknown strategy {strategy!r}")


def mesh_for_strategy(strategy: str, n_devices: int) -> Mesh:
    """Build the (px, spp) mesh a strategy implies (see strategy_spp_dim)."""
    spp_dim = strategy_spp_dim(strategy, n_devices)
    return make_mesh(px=n_devices // spp_dim, spp=spp_dim)


def render_sharded(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    backend: str = "auto",
    strategy: str = "pixels",
    mesh: Mesh | None = None,
    early_exit: bool = True,
    sample_offset: jax.Array | int = 0,
    compact: bool = True,
    sample_group: int | str = 1,
    scene_sharding: str = "replicated",
):
    """Render across all devices. Returns ``(image [H, W, 3], rays_traced)``.

    ``strategy``: ``"pixels"`` shards the image plane (best for big images),
    ``"samples"`` shards the spp axis (best for small images at high spp),
    ``"both"`` splits devices across the two axes. An explicit ``mesh``
    overrides the strategy.

    ``scene_sharding``: ``"replicated"`` (default) keeps full triangle
    buffers on every device; ``"blocks"`` shards them 1/n over the ``px``
    axis instead (SURVEY §5.8's large-scene layout) — rays are then
    replicated over ``px`` and per-shard search winners are lex-merged
    across the axis, bit-identical to replicated (see
    :func:`render_sharded_blocks`).

    ``sample_offset`` shifts every device's sample-id range — the hook for
    progressive/checkpointed accumulation on top of sharded rendering.
    """
    if mesh is None:
        mesh = mesh_for_strategy(strategy, len(jax.devices()))
    if scene_sharding == "blocks":
        return render_sharded_blocks(
            scene, camera, width, height, spp, max_bounce, seed=seed,
            backend=backend, mesh=mesh, early_exit=early_exit,
            sample_offset=sample_offset, compact=compact,
            sample_group=sample_group,
        )
    assert scene_sharding == "replicated", scene_sharding
    return _render_sharded_jit(
        scene, camera, width, height, spp, max_bounce, seed, backend, mesh,
        early_exit, sample_offset, compact, sample_group,
    )


# -----------------------------------------------------------------------------
# Block-sharded scene: triangle buffers 1/n per device (SURVEY §5.8).
# -----------------------------------------------------------------------------


def pad_scene_for_blocks(scene: Scene, n: int) -> Scene:
    """Pad a scene so its triangle buffers shard evenly over ``n`` devices.

    Blocks (128-triangle groups) must divide over the mesh axis; the pad
    appends inert triangles (all-zero: zero normals fail the backface test,
    exactly like ``Scene.build``'s lane padding) and — when an accel is
    attached — REBUILDS it, which reproduces the identical Morton order and
    block contents for the live triangles (padding rides at the tail with
    inverted AABBs and sentinel original indices), so renders of the padded
    scene are bit-identical to the original.
    """
    from raytracingc_tpu.ops.accel import BLOCK

    t0 = scene.triangles.count
    # Ceil both steps: a non-128-multiple count must round UP to blocks
    # first (floor-dividing computed a target SMALLER than the input and
    # crashed jnp.pad with negative padding — review r4 finding).
    blocks = max(-(-t0 // BLOCK), 1)
    b1 = -(-blocks // n) * n
    t1 = b1 * BLOCK
    if t1 == t0:
        return scene
    pad = t1 - t0
    tris = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)),
        scene.triangles,
    )
    out = scene.replace(triangles=tris)  # n_triangles (live) unchanged
    return out.with_accel() if scene.accel is not None else out


def _scene_block_specs(scene: Scene):
    """Per-leaf PartitionSpecs: triangle buffers shard dim 0 over ``px``,
    spheres/env replicate. The search and the resolve read the
    original-order SoA, whose contiguous shards the search globalizes and
    lex-merges; the accel's permuted tables shard alongside."""

    def spec(path, leaf):
        ks = jax.tree_util.keystr(path)
        if ks.startswith(".triangles.") or ks.startswith(".accel."):
            return P("px")
        return P()

    return jax.tree_util.tree_map_with_path(spec, scene)


def render_sharded_blocks(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    backend: str = "auto",
    mesh: Mesh | None = None,
    early_exit: bool = True,
    sample_offset: jax.Array | int = 0,
    compact: bool = True,
    sample_group: int | str = 1,
):
    """Render with triangle buffers BLOCK-SHARDED 1/n over the ``px`` axis.

    SURVEY §5.8's large-scene layout: instead of replicating the scene and
    sharding rays, each device holds a contiguous 1/n shard of every
    triangle buffer and traces ALL rays against its shard; per-bounce the
    per-shard winners lex-merge over the axis (``all_gather`` of (dst,
    original idx) — the search's own tie rule, so the merged winner is
    bit-identical to a whole-scene search) and the winning payload combines
    with a masked ``psum``. Rays and shading are replicated over ``px`` —
    duplicated elementwise work that is small next to the search for the
    scenes this layout exists for (search cost scales with triangles; per-
    device triangle memory drops to 1/n).

    The ``spp`` mesh axis still shards samples exactly as in the replicated
    mode. Requires block count % px == 0 — call :func:`pad_scene_for_blocks`
    first. Returns ``(image [H, W, 3], rays_traced)``.
    """
    if mesh is None:
        mesh = mesh_for_strategy("pixels", len(jax.devices()))
    return _render_sharded_blocks_jit(
        scene, camera, width, height, spp, max_bounce, seed, backend, mesh,
        early_exit, sample_offset, compact, sample_group,
    )


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounce", "backend", "mesh", "seed",
        "early_exit", "compact", "sample_group"
    ),
)
def _render_sharded_blocks_jit(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int,
    backend: str,
    mesh: Mesh,
    early_exit: bool = True,
    sample_offset: jax.Array | int = 0,
    compact: bool = True,
    sample_group: int | str = 1,
):
    px_size = mesh.shape["px"]
    spp_size = mesh.shape["spp"]
    assert spp % spp_size == 0, f"spp={spp} not divisible by mesh spp={spp_size}"
    t = scene.triangles.count
    if t % (px_size * 128) != 0:
        raise ValueError(
            f"block sharding needs triangle padding {t} divisible by "
            f"px*128={px_size * 128}; run pad_scene_for_blocks(scene, "
            f"{px_size}) first"
        )
    spp_per = spp // spp_size
    base_offset = jnp.asarray(sample_offset, jnp.uint32)

    origins, dirs = primary_rays(camera, width, height)
    ray_ids = jnp.arange(width * height, dtype=jnp.uint32)

    def shard_fn(scene, o, d, ids):
        offset = base_offset + jax.lax.axis_index("spp").astype(
            jnp.uint32
        ) * jnp.uint32(spp_per)
        # The static tag routes nearest_hit/resolve_hit into their
        # cross-shard merge paths (ops/intersect.py).
        scene = scene.replace(shard_axis="px")
        radiance, count = trace_accumulate(
            o, d, scene, ids,
            seed=seed, spp=spp_per, max_bounce=max_bounce, backend=backend,
            sample_offset=offset, early_exit=early_exit, compact=compact,
            sample_group=sample_group,
        )
        radiance = jax.lax.pmean(radiance, "spp")
        # Every px rank traced every (logical) ray of its spp shard — the
        # count is already replicated over px; sum samples only.
        count = count.psum("spp")
        return radiance, count.value()

    radiance, count = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(_scene_block_specs(scene), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(scene, origins, dirs, ray_ids)

    image = radiance.reshape(height, width, 3)
    return image, count


# -----------------------------------------------------------------------------
# Sharded differentiable training: inverse rendering over a device mesh.
# -----------------------------------------------------------------------------


def make_train_step(
    mesh: Mesh,
    optimizer,
    spp: int,
    max_bounce: int,
    backend: str = "auto",
    seed: int = 0,
    param_filter=None,
    geometry_trainable: bool = True,
):
    """Build a jitted SPMD training step for inverse rendering.

    The step renders the scene from fixed primary rays, takes an L2 loss
    against a target radiance image, differentiates w.r.t. every scene leaf
    (vertex positions, normals, materials, environment), ``pmean``s the
    gradients over the whole mesh, and applies an ``optax`` update — the
    canonical replicated-parameter / sharded-data layout.

    ``param_filter(path_leaf_grads) -> grads`` may zero out leaves that should
    stay frozen (e.g. train albedo only). Returns
    ``step(scene, opt_state, origins, dirs, ray_ids, target) ->
    (scene, opt_state, loss)``; inputs sharded over ``px``, scene/opt_state
    replicated.

    The scene's ``accel`` (int indices + a geometry copy) is detached from
    differentiation internally; initialize ``opt_state`` with
    ``optimizer.init(scene.replace(accel=None))``.

    With the default ``geometry_trainable=True`` and an accel-carrying
    scene, the loss runs against a **refreshed accel**
    (:func:`~raytracingc_tpu.ops.accel.refresh_accel`): the host-built
    Morton permutation stays static while the permuted geometry copy and
    block AABBs are regenerated in-trace from the current triangles —
    exact at every step, O(T) per refresh, with only locality ageing as
    vertices drift from the sort (re-sort host-side every k steps; see
    ``fit_scene(accel_rebuild_every=...)``). A scene WITHOUT an accel runs
    the loss accel-free. Pass ``geometry_trainable=False`` for
    material/env-only training to keep the (then-valid) frozen accel inside
    the loss with no per-step refresh.

    The returned step keeps the scene's accel consistent: geometry steps
    return the accel refreshed against the UPDATED triangles, so the
    returned scene renders correctly as-is.
    """
    from raytracingc_tpu.ops.accel import refresh_accel

    spp_size = mesh.shape["spp"]
    assert spp % spp_size == 0, f"spp={spp} not divisible by mesh spp={spp_size}"
    spp_per = spp // spp_size

    def shard_step(scene, opt_state, origins, dirs, ray_ids, target):
        offset = jax.lax.axis_index("spp").astype(jnp.uint32) * jnp.uint32(spp_per)
        accel = scene.accel
        n_live = scene.n_triangles
        refresh = (
            geometry_trainable
            and accel is not None
            and accel.perm_of_orig is not None
        )
        loss_accel = None if geometry_trainable else accel
        scene = scene.replace(accel=None)

        def loss_fn(s):
            a = refresh_accel(accel, s.triangles, n_live) if refresh \
                else loss_accel
            radiance, _ = trace_accumulate(
                origins,
                dirs,
                s.replace(accel=a),
                ray_ids,
                seed=seed,
                spp=spp_per,
                max_bounce=max_bounce,
                backend=backend,
                sample_offset=offset,
            )
            radiance = jax.lax.pmean(radiance, "spp")
            return jnp.mean((radiance - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(scene)
        loss = jax.lax.pmean(loss, ("px", "spp"))
        grads = jax.lax.pmean(grads, ("px", "spp"))
        if param_filter is not None:
            grads = param_filter(grads)
        updates, opt_state = optimizer.update(grads, opt_state, scene)
        scene = jax.tree_util.tree_map(lambda p, u: p + u, scene, updates)
        # A stale accel must never ride along with updated geometry: refresh
        # against the post-update triangles (so the returned scene is
        # self-consistent) or drop it (accel-free geometry training; the
        # caller rebuilds once training ends, ``Scene.with_accel``).
        out_accel = (
            refresh_accel(accel, scene.triangles, n_live)
            if refresh
            else loss_accel
        )
        return scene.replace(accel=out_accel), opt_state, loss

    sharded = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P(), P("px"), P("px"), P("px"), P("px")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
