"""Multi-device collective cost model: payload bytes from compiled HLO.

Turns a multi-device throughput extrapolation into payload-bytes arithmetic:

1. **Collective inventory from compiled HLO.** Lowers the sharded render on
   an 8-virtual-device CPU mesh for each scene layout and extracts every
   cross-device collective (op, element type, shape, bytes) from the
   compiled module text. Collectives inside the bounce ``scan``/``while``
   execute once PER BOUNCE — the inventory tags them by position so the
   per-ray-per-bounce payload can be read off directly.
2. **CPU strong-scaling table.** Times the same global workload at
   px = 1/2/4/8 virtual devices. CPU emulation shares the same cores and
   understates the interconnect (collectives are memcpys here), so the
   EFFICIENCY column
   is a lower-is-suspicious sanity signal, not a throughput prediction —
   the payload table above is the transferable artifact.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
          python tools/multichip_cost.py
(or just `python tools/multichip_cost.py`; it forces CPU itself).

Results are written to ``multichip_cost.json`` at the repository root.
"""

import json
import os
import re
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.parallel.mesh import make_mesh
from raytracingc_tpu.parallel.sharded import (
    pad_scene_for_blocks,
    render_sharded,
)
from raytracingc_tpu.scene.builder import scene_from_obj

MODELS = "/root/reference/3Dmodels"

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

# `f32[8,16384]` / `s32[512]` / `pred[]` — the shape tokens HLO prints.
_SHAPE_RE = re.compile(r"\b(f64|s64|u64|f32|s32|u32|bf16|f16|s16|u16|s8|u8|pred)\[([0-9,]*)\]")
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "collective-permute",
    "all-to-all",
)


def _shape_bytes(tok_dtype: str, tok_dims: str) -> int:
    n = 1
    for d in tok_dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[tok_dtype]


def collective_inventory(hlo_text: str):
    """Every collective op in the compiled module: (op, result_bytes, line).

    The result shape of an all-gather is the FULL gathered buffer (each
    device receives (n-1)/n of it over links); an all-reduce's is the
    reduced buffer (ring cost ~2·(n-1)/n of it per device).
    """
    out = []
    for line in hlo_text.splitlines():
        s = line.strip()
        for op in _COLLECTIVES:
            # match the op as the instruction (e.g. "= f32[...] all-gather(")
            if f" {op}(" in s or f" {op}-start(" in s:
                lhs = s.split(f" {op}(")[0].split(f" {op}-start(")[0]
                bytes_total = sum(
                    _shape_bytes(m.group(1), m.group(2))
                    for m in _SHAPE_RE.finditer(lhs)
                )
                out.append({"op": op, "result_bytes": bytes_total,
                            "hlo": s[:160]})
                break
    return out


def _render_lowered(scene, mesh, w, h, spp, bounces, scene_sharding):
    def f(scene):
        return render_sharded(
            scene, Camera.look_at(), w, h, spp=spp, max_bounce=bounces,
            seed=0, mesh=mesh, scene_sharding=scene_sharding,
        )

    return jax.jit(f).lower(scene).compile()


def payload_report(w=64, h=64, spp=8, bounces=4):
    scene = scene_from_obj(os.path.join(MODELS, "suzannes.obj"))
    n = len(jax.devices())
    rays = w * h
    report = {}

    configs = [
        ("replicated_px", make_mesh(px=n, spp=1), "replicated", scene),
        ("replicated_spp", make_mesh(px=1, spp=n), "replicated", scene),
        ("blocks_px", make_mesh(px=n, spp=1), "blocks",
         pad_scene_for_blocks(scene, n)),
    ]
    for name, mesh, sharding, sc in configs:
        compiled = _render_lowered(sc, mesh, w, h, spp, bounces, sharding)
        inv = collective_inventory(compiled.as_text())
        total = sum(e["result_bytes"] for e in inv)
        report[name] = {
            "mesh": dict(mesh.shape),
            "collectives": inv,
            "static_total_bytes": total,
            "note": (
                "ops inside the bounce loop execute once per bounce; "
                f"rays={rays}, spp={spp}, bounces={bounces}"
            ),
        }
        print(f"[{name}] {len(inv)} collective(s), "
              f"static result bytes {total:,}")
        for e in inv:
            print(f"    {e['op']:>20}  {e['result_bytes']:>12,} B   "
                  f"{e['hlo'][:100]}")
    return report


def strong_scaling(w=128, h=128, spp=8, bounces=4, repeats=3):
    scene = scene_from_obj(os.path.join(MODELS, "suzannes.obj"))
    cam = Camera.look_at()
    rows = []
    for px in (1, 2, 4, 8):
        mesh = make_mesh(px=px, spp=1)
        img, count = render_sharded(
            scene, cam, w, h, spp=spp, max_bounce=bounces, seed=0, mesh=mesh
        )
        jax.block_until_ready(img)  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            img, count = render_sharded(
                scene, cam, w, h, spp=spp, max_bounce=bounces, seed=0,
                mesh=mesh,
            )
            jax.block_until_ready(img)
            best = min(best, time.perf_counter() - t0)
        rays_s = float(count) / best
        rows.append({"px": px, "wall_s": round(best, 4),
                     "rays_per_s": rays_s})
        base = rows[0]["rays_per_s"]
        eff = rays_s / (base * px)
        rows[-1]["efficiency_vs_1dev"] = round(eff, 3)
        print(f"px={px}: wall {best*1e3:8.1f} ms  {rays_s/1e6:7.2f} M rays/s  "
              f"eff {eff:.2f}")
    return rows


def main():
    print(f"devices: {len(jax.devices())} ({jax.devices()[0].platform})")
    report = {
        "payload": payload_report(),
        "strong_scaling_cpu": strong_scaling(),
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "multichip_cost.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {os.path.abspath(out)}")


if __name__ == "__main__":
    main()
