"""Top-level rendering entry points.

Replaces the reference's pthread row-cyclic executor (``rowThread`` +
spawn/join, ``main.c:81-105,284-303``) with a single ``jit``-compiled program:
primary rays for all pixels are generated as one batch, traced through the
masked-scan integrator, and averaged over samples. Large images are processed
in fixed-size pixel chunks under ``lax.map`` so device memory stays bounded
regardless of resolution; multi-chip execution shards the pixel axis instead
(see ``raytracingc_tpu.parallel``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.render.image import tonemap_to_bytes, write_image
from raytracingc_tpu.render.integrator import trace_accumulate
from raytracingc_tpu.scene.types import Scene


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_bounce", "backend", "pixel_chunk",
        "early_exit", "compact", "sample_batch", "sample_group",
    ),
)
def render(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    backend: str = "auto",
    pixel_chunk: int | None = None,
    early_exit: bool = True,
    sample_offset: jax.Array | int = 0,
    compact: bool = True,
    sample_batch: int | str = 1,
    sample_group: int | str = 1,
) -> tuple[jax.Array, jax.Array]:
    """Render linear radiance. Returns ``(image [H, W, 3] f32, rays_traced)``.

    ``pixel_chunk`` bounds per-step device memory: pixels are padded to a
    multiple and traced chunk-by-chunk under ``lax.map``. ``None`` picks a
    chunk that keeps the live ray state comfortably inside HBM.

    ``early_exit`` (default on) stops each chunk's bounce loop once all its
    lanes are dead and accumulates samples hit-front (see
    ``integrator._hit_front_accumulate``). Per-lane radiance equals the
    fixed-length scan up to float re-association of the bounce-0 light sum
    (~1e-6) with exactly equal traced-ray counts. Every chunk width runs
    the same per-lane arithmetic with the same ``light0*spp + sum(rest)``
    association, but XLA compiles a multi-chunk frame (a ``lax.map`` loop
    body) and a one-chunk frame differently: the two can differ in the
    last bit of some rays, and then in the few pixels where that bit flips
    a discrete choice (12 of 2,073,600 at 1080p × 8 spp on an H100).
    Pixel-sharded ``render_sharded`` equals the one-chunk frame bit for bit.
    NOT reverse-differentiable; pass ``False`` when differentiating —
    with ``compact=True`` (the default) that is still the FAST hit-front
    path (fixed-length continuation in the compacted domain, bit-identical
    forward values), not the full-width scan; ``compact=False`` selects the
    plain scan oracle.

    ``sample_group`` batches that many samples of the hit-front continuation
    into one widened trace (``"auto"`` targets 64k rays) — fewer,
    larger launches. Per-lane arithmetic and the accumulation association
    are identical at any group size (slices add sequentially in sample
    order), so results agree within the repo-wide ~1-ulp XLA
    fusion-context wobble across program shapes — and the traced-ray
    counts exactly. The default stays 1 because the BITWISE
    chunking/sharding invariance is pinned for the default configuration;
    opt in for throughput (bench.py autotunes it and reports the winner).
    """
    n_pix = width * height
    if pixel_chunk is None:
        # 64k-ray chunks + live-lane compaction. Compaction makes
        # secondary-bounce cost track the live-lane count. On an H100 a
        # 1080p x 8 spp frame ran 2.4x faster as one chunk; the default
        # waits for a chunk derived from device memory.
        pixel_chunk = int(min(max(_round_up(n_pix, 1024), 1024), 65536))
    origins, dirs = primary_rays(camera, width, height)
    ray_ids = jnp.arange(n_pix, dtype=jnp.uint32)

    padded = _round_up(n_pix, pixel_chunk)
    active = jnp.arange(padded, dtype=jnp.int32) < n_pix
    if padded != n_pix:
        pad = padded - n_pix
        origins = jnp.pad(origins, ((0, pad), (0, 0)))
        # Padding rays get a valid unit direction so the integrator math stays
        # finite; the active mask keeps them dead (no radiance, no ray count).
        dirs = jnp.pad(dirs, ((0, pad), (0, 0)), constant_values=0.0)
        dirs = dirs.at[n_pix:, 2].set(1.0)
        ray_ids = jnp.pad(ray_ids, (0, pad))
    n_chunks = padded // pixel_chunk

    def one_chunk(args):
        o, d, ids, act = args
        return trace_accumulate(
            o, d, scene, ids, seed=seed, spp=spp, max_bounce=max_bounce,
            backend=backend, active=act, early_exit=early_exit,
            sample_offset=sample_offset, compact=compact,
            sample_batch=sample_batch, sample_group=sample_group,
        )

    if n_chunks == 1:
        radiance, count = one_chunk((origins, dirs, ray_ids, active))
    else:
        resh = lambda x: x.reshape(n_chunks, pixel_chunk, *x.shape[1:])
        radiance, counts = jax.lax.map(
            one_chunk, (resh(origins), resh(dirs), resh(ray_ids), resh(active))
        )
        radiance = radiance.reshape(padded, 3)
        count = counts.sum()

    image = radiance[:n_pix].reshape(height, width, 3)
    return image, count.value()


def render_image(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_bounce: int,
    seed: int = 0,
    backend: str = "auto",
    output: str | None = None,
    pixel_chunk: int | None = None,
) -> np.ndarray:
    """Render and tonemap to uint8 (and optionally write a BMP/PNG file)."""
    linear, _ = render(
        scene,
        camera,
        width,
        height,
        spp,
        max_bounce,
        seed=seed,
        backend=backend,
        pixel_chunk=pixel_chunk,
    )
    img = tonemap_to_bytes(np.asarray(jax.device_get(linear)))
    if output is not None:
        write_image(output, img)
    return img
