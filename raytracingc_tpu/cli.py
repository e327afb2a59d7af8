"""Command-line driver, mirroring the reference CLI (``main.c:107-244``).

Every reference flag is supported with the same spelling and defaults:
``-i/--input`` (.obj path; absent → "default" mode = ``triangles.txt`` plus the
hard-coded sphere), ``-o/--output`` (default ``out.bmp``), ``-p/--pos``,
``-t/--track``, ``-f/--fov``, ``-s/--size`` (default 128×128),
``-b/--max-bounce`` (default 10), ``-gc/--ground-color``,
``-sch/--sky-color-horizon``, ``-scz/--sky-color-zenith``, and
``--sun x y z focus intensity``.

Additions the C version hard-codes or lacks: ``--spp`` (the reference fixes
4000 samples at compile time, ``scene.h:26``), ``--seed``, ``--triangles``
(choose a triangles.txt path), ``--backend``, ``--shard``, and ``--profile``.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracingc-tpu",
        description="Differentiable Monte-Carlo path tracer in JAX "
        "(same capabilities as RayTracingC).",
    )
    p.add_argument("-i", "--input", default=None, metavar="path/to/file.obj",
                   help=".obj scene; omit for default mode (triangles.txt + sphere)")
    p.add_argument("-o", "--output", default="out.bmp", help="output image (.bmp/.png)")
    p.add_argument("-p", "--pos", nargs=3, type=float, default=[-4.75, -1.5, -4.75],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("-t", "--track", nargs=3, type=float, default=[0.9, -1.2, 1.0],
                   metavar=("X", "Y", "Z"), help="look-at point")
    p.add_argument("-f", "--fov", type=float, default=1.0,
                   help="focal-length scalar (bigger = narrower FOV)")
    p.add_argument("-s", "--size", nargs=2, type=int, default=[128, 128],
                   metavar=("W", "H"), help="image size")
    p.add_argument("-b", "--max-bounce", type=int, default=10, help="max path length")
    p.add_argument("-gc", "--ground-color", nargs=3, type=float,
                   default=[0.66, 0.66, 0.66], metavar=("R", "G", "B"))
    p.add_argument("-sch", "--sky-color-horizon", nargs=3, type=float,
                   default=[1.0, 1.0, 1.0], metavar=("R", "G", "B"))
    p.add_argument("-scz", "--sky-color-zenith", nargs=3, type=float,
                   default=[0.263, 0.969, 0.871], metavar=("R", "G", "B"))
    p.add_argument("--sun", nargs=5, type=float,
                   default=[-30.0, -85.0, 100.0, 22.0, 0.75],
                   metavar=("X", "Y", "Z", "FOCUS", "INTENSITY"))
    # Extensions over the C CLI:
    p.add_argument("--spp", type=int, default=4000,
                   help="samples per pixel (the reference hard-codes 4000)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--triangles", default="triangles.txt",
                   help="triangles.txt path for default mode")
    p.add_argument("--backend", choices=["auto", "xla", "triton"], default="auto",
                   help="closest-hit search: the XLA scan or the fused GPU "
                   "kernel; auto picks triton on a GPU and xla on the CPU")
    p.add_argument("--tessellate", type=int, default=0, metavar="LEVELS",
                   help="midpoint-subdivide the scene 4^LEVELS-fold before "
                   "rendering (same image, more triangles)")
    p.add_argument("--shard", choices=["none", "pixels", "samples"], default="none",
                   help="multi-device sharding strategy")
    p.add_argument("--scene-sharding", choices=["replicated", "blocks"],
                   default="replicated",
                   help="with --shard: replicate triangle buffers on every "
                   "device (default) or block-shard them 1/n per device "
                   "(SURVEY 5.8 large-scene layout; bit-matched winners)")
    p.add_argument("--pixel-chunk", type=int, default=None,
                   help="pixels traced per device step (memory bound)")
    p.add_argument("--profile", action="store_true", help="print timing breakdown")
    p.add_argument("--debug-bounces", action="store_true",
                   help="render the bounce-count heatmap instead of radiance "
                        "(the reference's calcDebugColor, raytracing.c:242-260)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a device profile trace to DIR (TensorBoard)")
    p.add_argument("--checkpoint", metavar="FILE.npz", default=None,
                   help="progressive sample-batch checkpointing (resumable)")
    p.add_argument("--batch-spp", type=int, default=64,
                   help="samples per checkpoint batch (with --checkpoint)")
    # Multi-host bring-up (jax.distributed).
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import jax.numpy as jnp
    import numpy as np

    from raytracingc_tpu.camera import Camera
    from raytracingc_tpu.render.image import tonemap_to_bytes, write_image
    from raytracingc_tpu.scene.builder import scene_from_obj, scene_from_triangles_txt
    from raytracingc_tpu.scene.types import EnvParams
    from raytracingc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.num_processes or args.coordinator:
        from raytracingc_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)

    if args.trace:
        import jax as _jax

        _jax.profiler.start_trace(args.trace)

    t0 = time.time()
    sun = np.array(args.sun[:3], np.float32)
    sun = sun / np.linalg.norm(sun)
    env = EnvParams(
        sun_direction=jnp.asarray(sun),
        sky_horizon=jnp.asarray(np.array(args.sky_color_horizon, np.float32)),
        sky_zenith=jnp.asarray(np.array(args.sky_color_zenith, np.float32)),
        ground=jnp.asarray(np.array(args.ground_color, np.float32)),
        sun_focus=jnp.float32(args.sun[3]),
        sun_intensity=jnp.float32(args.sun[4]),
    )
    if args.input is None:
        print(f"Starting raytracingc-tpu in default mode ({args.triangles})")
        scene = scene_from_triangles_txt(args.triangles, env=env)
    else:
        print(f"Starting raytracingc-tpu in OBJ mode ({args.input})")
        scene = scene_from_obj(args.input, env=env)
    if args.tessellate > 0:
        from raytracingc_tpu.scene.builder import tessellate

        tris, n_live = tessellate(
            scene.triangles, scene.n_triangles, levels=args.tessellate
        )
        scene = scene.replace(
            triangles=tris, n_triangles=n_live, accel=None
        ).with_accel()
    t_load = time.time() - t0
    print(f"Scene: {scene.n_triangles} triangles, {scene.n_spheres} spheres "
          f"(loaded in {t_load:.2f}s)")

    cam = Camera.look_at(origin=args.pos, target=args.track, fov=args.fov)
    width, height = args.size

    if args.scene_sharding != "replicated" and (
        args.shard == "none" or args.checkpoint or args.debug_bounces
    ):
        # Only the plain sharded render honors block sharding today; a
        # silently-dropped flag would make the user measure the wrong
        # configuration (review r4 finding).
        raise SystemExit(
            "--scene-sharding blocks requires --shard pixels|samples and "
            "is not supported with --checkpoint/--debug-bounces"
        )

    t1 = time.time()
    if args.debug_bounces:
        from raytracingc_tpu.render.integrator import render_debug

        linear = np.asarray(render_debug(
            scene, cam, width, height, max_bounce=args.max_bounce,
            seed=args.seed, backend=args.backend,
        ))
        count = float(width * height)
    elif args.checkpoint:
        from raytracingc_tpu.render.progressive import render_progressive

        # --shard composes with --checkpoint: each sample batch renders
        # across all devices, and the accumulated sum checkpoints between
        # batches — the multi-chip AND preemption-safe production path.
        linear, count = render_progressive(
            scene, cam, width, height, spp=args.spp,
            max_bounce=args.max_bounce, seed=args.seed, backend=args.backend,
            batch_spp=args.batch_spp, checkpoint_path=args.checkpoint,
            shard_strategy=None if args.shard == "none" else args.shard,
        )
    elif args.shard == "none":
        from raytracingc_tpu.render.renderer import render

        linear, count = render(
            scene, cam, width, height,
            spp=args.spp, max_bounce=args.max_bounce, seed=args.seed,
            backend=args.backend, pixel_chunk=args.pixel_chunk,
        )
    else:
        from raytracingc_tpu.parallel.sharded import (
            pad_scene_for_blocks,
            render_sharded,
            strategy_spp_dim,
        )

        if args.scene_sharding == "blocks":
            import jax

            n_dev = len(jax.devices())
            scene = pad_scene_for_blocks(
                scene, n_dev // strategy_spp_dim(args.shard, n_dev)
            )
        linear, count = render_sharded(
            scene, cam, width, height,
            spp=args.spp, max_bounce=args.max_bounce, seed=args.seed,
            backend=args.backend, strategy=args.shard,
            scene_sharding=args.scene_sharding,
        )
    linear = np.asarray(linear)
    t_render = time.time() - t1

    img = tonemap_to_bytes(linear)
    write_image(args.output, img)
    rays = float(count)
    print(f"Rendered {width}x{height} @ {args.spp} spp, {args.max_bounce} bounces "
          f"in {t_render:.2f}s — {rays:.3g} rays traced "
          f"({rays / max(t_render, 1e-9):.3g} rays/s) → {args.output}")
    if args.profile:
        print(f"[profile] load={t_load:.3f}s render={t_render:.3f}s")
    if args.trace:
        import jax as _jax

        _jax.profiler.stop_trace()
        print(f"[trace] device profile written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
