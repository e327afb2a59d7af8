"""Regenerate the example render gallery (examples/renders/*.png).

Each shot mirrors a scene from the reference's committed ``images/`` gallery
(the author's informal regression record, SURVEY.md §4) rendered by this
framework on one device. Run: ``python examples/render_gallery.py``
(optionally ``--size N --spp N``).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "renders")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--only", default=None, help="render just this shot name")
    args = ap.parse_args()

    import jax
    import numpy as np

    from raytracingc_tpu.camera import Camera
    from raytracingc_tpu.render.image import tonemap_to_bytes, write_image
    from raytracingc_tpu.render.progressive import render_progressive
    from raytracingc_tpu.scene.builder import (
        scene_from_obj,
        scene_from_triangles_txt,
    )
    from raytracingc_tpu.scene.types import EnvParams

    import jax.numpy as jnp

    default_cam = Camera.look_at()

    def sun_env():
        sun = np.array([-30.0, -85.0, 100.0], np.float32)
        sun /= np.linalg.norm(sun)
        return EnvParams.default().replace(
            sun_direction=jnp.asarray(sun),
            sun_focus=jnp.float32(150.0),
            sun_intensity=jnp.float32(6.0),
        )

    # Enclosed scenes keep every path alive for all bounces (dense regime);
    # cap their spp so the gallery renders in minutes.
    spp_override = {"default_box": 1024, "box_scene": 1024,
                    # 247k triangles: keep it minutes.
                    "suzannes_x64_streamed": 256}
    shots = {
        "default_box": lambda: (
            scene_from_triangles_txt(os.path.join(REF, "triangles.txt")),
            default_cam,
        ),
        "suzannes": lambda: (
            scene_from_obj(os.path.join(REF, "3Dmodels/suzannes.obj")),
            default_cam,
        ),
        "ultracomplex": lambda: (
            scene_from_obj(os.path.join(REF, "3Dmodels/ultracomplex.obj")),
            default_cam,
        ),
        "rsuzanne": lambda: (
            scene_from_obj(os.path.join(REF, "3Dmodels/rsuzanne.obj")),
            default_cam,
        ),
        "box_scene": lambda: (
            scene_from_triangles_txt(
                os.path.join(os.path.dirname(OUT), "box_scene.txt")
            ),
            default_cam,
        ),
        "sun_glow": lambda: (
            scene_from_obj(os.path.join(REF, "3Dmodels/asuzane.obj"),
                           env=sun_env()),
            Camera.look_at(origin=[-3.0, -2.2, -5.0], target=[0.5, -1.0, 0.8]),
        ),
        # 247,552 triangles (suzannes ×64): visually identical to
        # "suzannes" by construction — the point IS that a scene 64× larger
        # renders the same.
        "suzannes_x64_streamed": lambda: (
            _tessellated(os.path.join(REF, "3Dmodels/suzannes.obj"), 3),
            default_cam,
        ),
    }

    def _tessellated(path, levels):
        from raytracingc_tpu.scene.builder import tessellate

        s = scene_from_obj(path)
        tris, n_live = tessellate(s.triangles, s.n_triangles, levels=levels)
        return s.replace(triangles=tris, n_triangles=n_live,
                         accel=None).with_accel()

    os.makedirs(OUT, exist_ok=True)
    for name, build in shots.items():
        if args.only and name != args.only:
            continue
        scene, cam = build()
        spp = min(args.spp, spp_override.get(name, args.spp))
        t0 = time.time()
        # Progressive batches: one device dispatch per 256 samples — long
        # single dispatches can trip device-side execution limits.
        linear, count = render_progressive(
            scene, cam, args.size, args.size,
            spp=spp, max_bounce=args.bounces, seed=0, batch_spp=256,
        )
        jax.block_until_ready(linear)
        dt = time.time() - t0
        path = os.path.join(OUT, f"{name}.png")
        write_image(path, tonemap_to_bytes(np.asarray(linear)))
        print(f"{name}: {args.size}x{args.size} @ {spp} spp in {dt:.1f}s "
              f"({float(count) / dt / 1e6:.1f}M rays/s) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
