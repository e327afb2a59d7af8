"""Progressive rendering with sample-batch checkpointing.

The reference accumulates all 4000 samples in one uninterruptible pass
(``main.c:98-99``); a crash loses everything (SURVEY.md §5.4). Here the spp
axis is split into batches with disjoint sample-id ranges (the counter-based
RNG makes batch k's streams identical whether or not batches 0..k-1 ran in
the same process), and the running radiance sum is snapshotted atomically
after each batch. A preempted job resumes at the next batch boundary with
output bit-identical to the same progressive run uninterrupted (the resumed
process replays the exact same sums). Relative to a ONE-SHOT render of the
same total spp, per-sample radiances are identical but the final average
re-associates float additions (batch partial means are de-averaged and
re-summed), so equality is within float re-association tolerance
(~2e-6 relative; pinned by tests), not bitwise.
"""

from __future__ import annotations

import os
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.scene.types import Scene
from raytracingc_tpu.utils.checkpoint import load_pytree, save_pytree


def _sg_int(sample_group) -> int:
    """Concrete divisor for the per-batch validity check ("auto" → 1 is
    always applicable: trace_accumulate resolves it per batch)."""
    return 1 if sample_group == "auto" else int(sample_group)


def render_progressive(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    *,
    batch_spp: int = 64,
    seed: int = 0,
    backend: str = "auto",
    checkpoint_path: str | None = None,
    resume: bool = True,
    on_batch: Callable[[int, int, jax.Array], None] | None = None,
    mesh=None,
    shard_strategy: str | None = None,
    sample_group: int | str = 1,
) -> tuple[jax.Array, jax.Array]:
    """Render ``spp`` samples in batches of ``batch_spp`` with checkpoints.

    Returns ``(image [H, W, 3] linear, rays_traced)`` — equal to
    :func:`render` with the same total spp and seed up to float
    re-association of the sample average (see module docstring). ``on_batch(done, total,
    partial_image)`` runs after each batch (progress bars, previews).

    Pass ``mesh`` or ``shard_strategy`` to run each batch across all devices
    via :func:`raytracingc_tpu.parallel.sharded.render_sharded` — the
    production configuration for long pod-scale renders: multi-chip AND
    preemption-safe (with ``shard_strategy="samples"``, ``batch_spp`` must be
    a multiple of the mesh's ``spp`` dimension).
    """
    if mesh is None and shard_strategy is None:
        # Pin the scene/camera on device once: every batch would otherwise
        # re-upload the numpy leaves. The sharded path places them per its
        # sharding.
        scene = jax.device_put(scene)
        camera = jax.device_put(camera)
    else:
        # Validate divisibility up front: with samples sharding, EVERY batch
        # (including the final partial one, spp % batch_spp) must divide the
        # mesh's spp dimension, or the last batch would trip the sharded
        # renderer's assert after most of the render already completed.
        strategy = shard_strategy or "pixels"
        if mesh is not None:
            spp_dim = mesh.shape.get("spp", 1)
        else:
            from raytracingc_tpu.parallel.sharded import strategy_spp_dim

            spp_dim = strategy_spp_dim(strategy, len(jax.devices()))

    n_batches = (spp + batch_spp - 1) // batch_spp
    acc = jnp.zeros((height, width, 3), jnp.float32)
    count = jnp.zeros((), jnp.float32)
    done_spp = 0

    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        (acc, count), saved = load_pytree(checkpoint_path, (acc, count))
        done_spp = saved or 0

    if (mesh is not None or shard_strategy is not None) and spp_dim > 1:
        # Validate against the batches the loop will ACTUALLY run — a resume
        # from a checkpoint written with a different batch_spp can start at
        # a done_spp that is no multiple of batch_spp, so the size sequence
        # must be derived from done_spp, not from 0.
        sizes = {
            min(batch_spp, spp - d) for d in range(done_spp, spp, batch_spp)
        }
        bad = sorted(b for b in sizes if b % spp_dim)
        if bad:
            raise ValueError(
                f"samples sharding over {spp_dim} devices needs every "
                f"batch divisible by {spp_dim}: got spp={spp}, "
                f"batch_spp={batch_spp}, resume offset {done_spp} "
                f"(offending batch sizes {bad}). Pick batch_spp a multiple "
                f"of {spp_dim} with spp % batch_spp also a multiple, or "
                f"shard by pixels."
            )

    while done_spp < spp:
        this = min(batch_spp, spp - done_spp)
        if mesh is not None or shard_strategy is not None:
            from raytracingc_tpu.parallel.sharded import render_sharded

            img, c = render_sharded(
                scene, camera, width, height, spp=this,
                max_bounce=max_bounce, seed=seed, backend=backend,
                strategy=shard_strategy or "pixels", mesh=mesh,
                sample_offset=jnp.uint32(done_spp),
                sample_group=sample_group if this % _sg_int(sample_group) == 0
                else 1,
            )
        else:
            img, c = render(
                scene,
                camera,
                width,
                height,
                spp=this,
                max_bounce=max_bounce,
                seed=seed,
                backend=backend,
                sample_offset=jnp.uint32(done_spp),
                # The final partial batch may not divide the group; drop to
                # the ungrouped schedule there rather than erroring.
                sample_group=sample_group if this % _sg_int(sample_group) == 0
                else 1,
            )
        acc = acc + img * np.float32(this)  # de-average back to a sum
        count = count + c
        done_spp += this
        if checkpoint_path:
            save_pytree(checkpoint_path, (acc, count), step=done_spp)
        if on_batch is not None:
            on_batch(done_spp, spp, acc / np.float32(done_spp))

    return acc / np.float32(spp), count
