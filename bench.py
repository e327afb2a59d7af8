"""Benchmark harness: traced rays/s of one render on the GPU.

Renders the in-repo room (``examples/box_scene.txt``, tessellated 4^4-fold
to 2,560 triangles plus the default sphere) at 1080p and reports traced rays
per second on the default JAX device, named in the output. Prints exactly
ONE JSON line:

    {"metric": ..., "value": N, "unit": "rays/s", ...}

The metric names the scene and its triangle count. There is no ratio to the
C reference: its anchors in ``BASELINE.md`` were taken on another scene.

It refuses to run anywhere but a GPU unless the caller set
``JAX_PLATFORMS=cpu`` explicitly (as the schema tests do); a CPU run is a
functional check, not a measurement.

Env overrides: BENCH_W, BENCH_H, BENCH_SPP, BENCH_BOUNCE, BENCH_SCENE (an
``.obj`` or ``triangles.txt`` path), BENCH_TESS (4^k tessellation; default
4 for the default scene, 0 for a named one), BENCH_BACKEND, BENCH_REPEATS, BENCH_CHUNK (pixel chunk), BENCH_COMPACT
(0/1, default 1), BENCH_SAMPLE_BATCH (int or "auto"), BENCH_SAMPLE_GROUP
(int or "auto"; unset → autotune over {1, auto} and report the winner —
same arithmetic and association at every point, so this is pure schedule
selection), BENCH_STREAM (frames enqueued back-to-back for the
steady-state throughput measurement; default 4, 1 = blocked-only; the
JSON records both numbers).

Modes:

* ``BENCH_MODE=train`` — times one inverse-rendering training step
  (render → L2 loss → grads → adam update) in BOTH the geometry-trainable
  (refreshed accel) and material-only (accel reused) variants, plus the
  matching forward render, and reports backward/forward ratios. Train
  defaults are smaller (256², spp 2, 4 bounces).
* ``BENCH_SHARD=pixels|samples|both`` — routes the render through
  ``render_sharded`` over all visible devices (shard_map overhead on one
  device, scaling on several); the JSON gains a ``mesh`` field.
"""

from __future__ import annotations

import json
import os
import sys
import time

DEFAULT_SCENE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "examples", "box_scene.txt"
)


def _bench_train(scene, cam, scene_path: str, device: str) -> int:
    """BENCH_MODE=train: one inverse-rendering step, both trainability modes.

    The training step is the same construction as ``fit_scene``'s inner
    step (render with the differentiable fixed-length scan → L2 loss →
    grads → adam update); geometry-trainable runs the loss against the
    per-step in-trace accel REFRESH (``refresh_accel`` — exact culling at
    training time, round 5), material-only reuses the frozen accel.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from raytracingc_tpu.camera import primary_rays
    from raytracingc_tpu.diff.optimize import leaf_filter
    from raytracingc_tpu.ops.accel import refresh_accel
    from raytracingc_tpu.render.integrator import trace_accumulate
    from raytracingc_tpu.render.renderer import render

    # Train defaults are smaller: the backward sweep roughly doubles cost.
    width = int(os.environ.get("BENCH_W", 256))
    height = int(os.environ.get("BENCH_H", 256))
    spp = int(os.environ.get("BENCH_SPP", 2))
    max_bounce = int(os.environ.get("BENCH_BOUNCE", 4))
    backend = os.environ.get("BENCH_BACKEND", "auto")
    repeats = int(os.environ.get("BENCH_REPEATS", 2))

    origins, dirs = primary_rays(cam, width, height)
    ray_ids = jnp.arange(width * height, dtype=jnp.uint32)
    target, _ = render(scene, cam, width, height, spp=spp,
                       max_bounce=max_bounce, seed=1, backend=backend)
    target = target.reshape(-1, 3)
    optimizer = optax.adam(1e-2)

    def make_step(loss_accel, pfilter, refresh=False):
        @jax.jit
        def step(scene_p, opt_state):
            def loss_fn(s):
                a = (
                    refresh_accel(loss_accel, s.triangles, s.n_triangles)
                    if refresh else loss_accel
                )
                radiance, count = trace_accumulate(
                    origins, dirs, s.replace(accel=a), ray_ids,
                    seed=0, spp=spp, max_bounce=max_bounce, backend=backend,
                )
                return jnp.mean((radiance - target) ** 2), count

            (loss, count), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(scene_p)
            if pfilter is not None:
                grads = pfilter(grads)
            updates, opt_state = optimizer.update(grads, opt_state, scene_p)
            scene_p = jax.tree_util.tree_map(
                lambda p, u: p + u, scene_p, updates)
            return scene_p, opt_state, loss, count

        return step

    accel = scene.accel
    scene_p = scene.replace(accel=None)
    opt_state = optimizer.init(scene_p)

    def time_step(step):
        s, o, loss, count = step(scene_p, opt_state)  # compile + warm
        jax.block_until_ready(loss)
        best = float("inf")
        for _ in range(max(repeats, 1)):
            t0 = time.time()
            s, o, loss, count = step(scene_p, opt_state)
            jax.block_until_ready(loss)
            best = min(best, time.time() - t0)
        return best, float(count)

    # Geometry-trainable: per-step accel refresh when the scene has a real
    # accel (round 5 — vertex training with full culling); accel-free
    # otherwise, or on BENCH_TRAIN_ACCELFREE=1 for the A/B.
    accel_free = os.environ.get("BENCH_TRAIN_ACCELFREE", "0") == "1"
    use_refresh = (
        scene.accel is not None
        and scene.accel.perm_of_orig is not None
        and not accel_free
    )
    geom_s, geom_rays = time_step(
        make_step(scene.accel, None, refresh=True) if use_refresh
        else make_step(None, None)
    )
    mat_s, mat_rays = time_step(
        make_step(accel, leaf_filter(["albedo", "emission", "smoothness",
                                      "env"])))

    # Forward-only anchor at the SAME config and integrator (the
    # differentiable fixed-length scan, accel on) for honest fwd:bwd ratios.
    fwd_fn = jax.jit(lambda: trace_accumulate(
        origins, dirs, scene, ray_ids, seed=0, spp=spp,
        max_bounce=max_bounce, backend=backend))
    jax.block_until_ready(fwd_fn()[0])
    fwd_s = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.time()
        r, fwd_rays = fwd_fn()
        jax.block_until_ready(r)
        fwd_s = min(fwd_s, time.time() - t0)
    fwd_rays = float(fwd_rays)

    result = {
        "metric": f"train-step rays/s (geometry-trainable), "
        f"{os.path.basename(scene_path)} {width}x{height} spp={spp} "
        f"b={max_bounce} [{device}]",
        "value": round(geom_rays / geom_s, 1),
        "unit": "rays/s",
        "geom_step_s": round(geom_s, 4),
        "material_step_s": round(mat_s, 4),
        "material_rays_s": round(mat_rays / mat_s, 1),
        "forward_scan_s": round(fwd_s, 4),
        "forward_scan_rays_s": round(fwd_rays / fwd_s, 1),
        "geom_over_forward": round(geom_s / fwd_s, 2),
        "material_over_forward": round(mat_s / fwd_s, 2),
        "repeats": repeats,
        "device_kind": device,
        "geom_loss_accel": "refresh" if use_refresh else "none",
        "ray_accounting": "logical (forward rays per step; backward sweep "
        "included in the time)",
    }
    print(json.dumps(result))
    return 0


def _load_scene(path: str, tess: int):
    """Load an ``.obj`` or ``triangles.txt`` scene, tessellated 4^tess-fold."""
    from raytracingc_tpu.scene.builder import (
        scene_from_obj,
        scene_from_triangles_txt,
        tessellate,
    )
    from raytracingc_tpu.scene.types import Scene

    if not os.path.exists(path):
        raise SystemExit(f"BENCH_SCENE {path!r} does not exist")
    load = scene_from_obj if path.endswith(".obj") else scene_from_triangles_txt
    scene = load(path)
    label = f"{os.path.basename(path)} ({scene.n_triangles} tris)"
    if tess:
        tris, n_live = tessellate(
            scene.triangles, scene.n_triangles, levels=tess
        )
        scene = Scene.build(
            triangles=tris, spheres=scene.spheres, env=scene.env
        ).replace(
            n_triangles=n_live, n_spheres=scene.n_spheres
        ).with_accel()
        label = f"{os.path.basename(path)} ×{4 ** tess} ({n_live} tris)"
    return scene, label


def main() -> int:
    width = int(os.environ.get("BENCH_W", 1920))
    height = int(os.environ.get("BENCH_H", 1080))
    spp = int(os.environ.get("BENCH_SPP", 8))
    max_bounce = int(os.environ.get("BENCH_BOUNCE", 8))
    backend = os.environ.get("BENCH_BACKEND", "auto")
    repeats = int(os.environ.get("BENCH_REPEATS", 2))
    scene_path = os.environ.get("BENCH_SCENE", DEFAULT_SCENE)
    tess = int(os.environ.get(
        "BENCH_TESS", "0" if "BENCH_SCENE" in os.environ else "4"))
    pixel_chunk = os.environ.get("BENCH_CHUNK")
    pixel_chunk = int(pixel_chunk) if pixel_chunk else None
    compact = os.environ.get("BENCH_COMPACT", "1") == "1"
    sample_batch_env = os.environ.get("BENCH_SAMPLE_BATCH", "1")
    sample_batch = (
        "auto" if sample_batch_env == "auto" else int(sample_batch_env)
    )
    sample_group_env = os.environ.get("BENCH_SAMPLE_GROUP", "1")
    sample_group = (
        "auto" if sample_group_env == "auto" else int(sample_group_env)
    )

    import jax

    from raytracingc_tpu.utils.compile_cache import enable_compile_cache

    platform = jax.default_backend()
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {platform!r}. Set "
            "JAX_PLATFORMS=cpu to run it on the CPU as a functional check."
        )
    enable_compile_cache()
    device = jax.devices()[0].device_kind

    from raytracingc_tpu.camera import Camera
    from raytracingc_tpu.render.renderer import render

    scene, scene_label = _load_scene(scene_path, tess)
    cam = Camera.look_at()

    # Pin the scene + camera on the device once: a deployment keeps the scene
    # resident across frames. Static fields (n_triangles, n_spheres) are
    # pytree metadata and are untouched.
    scene = jax.device_put(scene)
    cam = jax.device_put(cam)

    mode = os.environ.get("BENCH_MODE", "render")
    if mode == "train":
        return _bench_train(scene, cam, scene_label, device)

    shard = os.environ.get("BENCH_SHARD")
    mesh = None
    if shard:
        from raytracingc_tpu.parallel.sharded import (
            mesh_for_strategy,
            render_sharded,
        )

        try:
            mesh = mesh_for_strategy(shard, len(jax.devices()))
        except ValueError as e:
            raise SystemExit(f"BENCH_SHARD: {e}")

    def launch(sg, chunk):
        if mesh is not None:
            img, count = render_sharded(
                scene, cam, width, height, spp=spp, max_bounce=max_bounce,
                seed=0, backend=backend, mesh=mesh, sample_group=sg,
            )
        else:
            img, count = render(
                scene, cam, width, height, spp=spp, max_bounce=max_bounce,
                seed=0, backend=backend, pixel_chunk=chunk,
                compact=compact, sample_batch=sample_batch,
                sample_group=sg,
            )
        return img, count

    def run(sg, chunk):
        img, count = launch(sg, chunk)
        jax.block_until_ready(img)
        return float(count)

    # Unless BENCH_SAMPLE_GROUP / BENCH_CHUNK pin values, autotune over a
    # small (sample_group, pixel_chunk) grid: every point computes the same
    # per-lane arithmetic with the same association (results agree within
    # the repo-wide ~1-ulp fusion wobble; counts exactly), so this is pure
    # schedule selection — a deployment would pick the same way. Sample batching cuts per-bounce
    # launches ~g×, which can move the chunk optimum up from the g=1 64k
    # sweet spot, hence the 128k×auto point. Winners are reported in the
    # JSON; every candidate's rays/s goes to stderr as the A/B record.
    pinned_sg = "BENCH_SAMPLE_GROUP" in os.environ
    pinned_chunk = pixel_chunk is not None
    if sample_batch != 1:
        # sample_batch>1 takes trace_accumulate's widened-batch branch
        # before sample_group is ever consulted — autotuning it would just
        # re-measure identical programs.
        candidates = [(1, pixel_chunk)]
    elif pinned_sg and pinned_chunk:
        candidates = [(sample_group, pixel_chunk)]
    elif pinned_sg:
        candidates = [(sample_group, None)]
    elif pinned_chunk:
        candidates = [(1, pixel_chunk), ("auto", pixel_chunk)]
    else:
        # Two-point schedule autotune.
        candidates = [(1, None), ("auto", None)]
    # Candidate budget: rather than risk a caller's timeout killing the run
    # with NO JSON emitted, stop starting new candidates once the elapsed
    # autotune time passes the budget and report the best so far (skips are
    # logged to stderr). The first candidate always runs.
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 900))
    t_start = time.time()
    best, compile_s = float("inf"), 0.0
    sample_group, pixel_chunk = candidates[0]
    for ci, (sg, chunk) in enumerate(candidates):
        if ci > 0 and time.time() - t_start > budget_s:
            print(f"# budget {budget_s:.0f}s exceeded: skipping candidates "
                  f"{candidates[ci:]}", file=sys.stderr)
            break
        t0 = time.time()
        count = run(sg, chunk)  # warmup + compile
        warm_s = time.time() - t0
        sg_best = float("inf")
        for _ in range(max(repeats, 1)):
            t0 = time.time()
            count = run(sg, chunk)
            sg_best = min(sg_best, time.time() - t0)
        if len(candidates) > 1:  # the A/B record behind the reported winner
            print(f"# sample_group={sg} chunk={chunk}: "
                  f"{count / sg_best:.4g} rays/s ({sg_best:.3f}s)",
                  file=sys.stderr)
        if sg_best < best:
            # compile_s keeps its historical meaning: the winner's own
            # warmup (compile + first run), not a sum over candidates.
            best, sample_group, pixel_chunk = sg_best, sg, chunk
            compile_s = warm_s

    blocked_rays_per_sec = count / best

    # Steady-state throughput: enqueue BENCH_STREAM frames back-to-back and
    # block once. JAX async dispatch pipelines them, hiding the per-call
    # host dispatch behind device compute — the number a deployment
    # rendering a frame stream actually sees. BENCH_STREAM=1 reverts to
    # blocked-only.
    stream = int(os.environ.get("BENCH_STREAM", 4))
    stream_rays_per_sec = None
    if stream > 1:
        t0 = time.time()
        outs = [launch(sample_group, pixel_chunk)[0] for _ in range(stream)]
        jax.block_until_ready(outs)
        stream_rays_per_sec = count * stream / (time.time() - t0)
        print(f"# stream x{stream}: {stream_rays_per_sec:.4g} rays/s vs "
              f"blocked {blocked_rays_per_sec:.4g}", file=sys.stderr)

    rays_per_sec = max(blocked_rays_per_sec, stream_rays_per_sec or 0.0)
    # The metric label names the methodology of the number actually
    # reported: if the blocked leg won the max() (pipelining didn't help),
    # the label must not claim "steady-state" (review r4 finding).
    stream_won = (
        stream_rays_per_sec is not None
        and stream_rays_per_sec >= blocked_rays_per_sec
    )
    shard_tag = f" shard={shard}" if shard else ""
    result = {
        "metric": f"traced rays/s, {scene_label} "
        f"{width}x{height} spp={spp} b={max_bounce}{shard_tag} [{device}]"
        + (f" steady-state x{stream}" if stream_won else ""),
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "blocked_rays_s": round(blocked_rays_per_sec, 1),
        "stream_frames": stream if stream_won else 1,
        # Provenance: the knobs behind the number, so it is self-describing.
        "repeats": repeats,
        "compile_s": round(compile_s, 2),
        "backend": backend,
        "platform": platform,
        "device_kind": device,
        "device_count": len(jax.devices()),
        "mesh": dict(mesh.shape) if mesh is not None else None,
        # Direct-path knobs are nulled in shard mode — render_sharded takes
        # none of them, and the A/B record must not attribute a measurement
        # to a configuration that never ran.
        "pixel_chunk": pixel_chunk if mesh is None else None,
        "compact": compact if mesh is None else None,
        "sample_batch": sample_batch if mesh is None else None,
        "sample_group": sample_group,
        # "logical" = one intersection charged per sample per live lane, as
        # the C loop executes them (raytracing.c:270); the primary-hit cache
        # means bounce-0 searches physically run once per pixel, not per
        # sample (see BASELINE.md "Ray accounting").
        "ray_accounting": "logical",
    }
    print(json.dumps(result))
    print(
        f"# {count:.3g} rays in {best:.3f}s (compile+first run {compile_s:.1f}s), "
        f"{scene.n_triangles} triangles",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
