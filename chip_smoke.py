"""Bring-up check of the render and fit path on NVIDIA GPUs.

Run from the repository root::

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

One process drives the card(s); only ``nvidia-smi`` runs as a child. Phases
(one GPU), each printing one line and raising on failure:

1. device: JAX version, device kind and count, card name and power limit,
   ``XLA_FLAGS``, the compile-cache directory;
2. search parity at real widths: the fused search kernel against the XLA
   scan on the in-repo room tessellated to 2,560 and 40,960 triangles (plus
   the default sphere), for the 1080p primary rays and 65,536 seeded random
   secondary rays; both searches timed alone, in turns;
3. resolve exactness: the one-hot matmul gather equals ``jnp.take`` bit for
   bit on the card;
4. production frame: ``render`` at 1920x1080, 8 spp, 8 bounces on 2,560
   triangles, kernel against XLA, timed in turns; the kernel's frame is
   bitwise the same under another pixel chunking;
5. CLI: ``raytracingc_tpu.cli.main`` renders a 128x128 BMP;
6. inverse rendering: ``fit_scene`` takes 3 vertex steps; one step's
   gradient matches the XLA search's.

``--four-cards`` runs only :func:`sharded_check` on the production frame:
``render_sharded`` by pixels, by samples and with block-sharded triangles
against the one-device frame rendered in one chunk, and one
``make_train_step`` step on a (px=2, spp=2) mesh against one device.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits with 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.ops.intersect import (
    _search_triangles_xla,
    gather_rows,
    nearest_hit,
    resolve_hit,
    sphere_table,
    triangle_table,
)
from raytracingc_tpu.ops.search_triton import search_triangles_triton
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.scene.builder import scene_from_triangles_txt, tessellate
from raytracingc_tpu.scene.types import Scene
from raytracingc_tpu.utils.compile_cache import enable_compile_cache

BOX_SCENE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "examples", "box_scene.txt"
)
FRAME = dict(width=1920, height=1080, spp=8, max_bounce=8)
# Two renders of one frame by different XLA programs (XLA vs kernel
# search; a frame traced in pixel chunks under ``lax.map`` vs in one call,
# which XLA compiles as a loop body vs a top-level program) differ in the
# last bit of some per-ray arithmetic. Over 3e7 traced rays a few such bits
# flip a discrete choice (an edge, a roulette draw): that pixel moves a lot
# and its paths trace a few more or fewer rays. So such frames agree when
# at most PIXEL_FRACTION of the pixels differ by more than FRAME_TOL
# (relative above 1.0) and the exact ray counts and the mean radiance are
# within COUNT_RTOL and MEAN_RTOL. The bounds sit just above the readings
# on an H100: 10 and 12 flipped pixels of 2,073,600; ray counts 0 and 18
# (5.6e-7) apart; mean radiance 0 and 5.2e-6 apart.
FRAME_TOL = 1e-5
PIXEL_FRACTION = 1e-5
COUNT_RTOL = 1e-6
MEAN_RTOL = 6e-6
# A sharded frame against the one-device frame rendered in one chunk, as a
# share of max(|radiance|, 1): the pixel layouts run the same per-ray
# program; the samples layout averages per-device means, which
# re-associates the sum of samples.
SHARD_TOL = 1e-6
# Kernel vs XLA vertex gradient, relative to its norm: the same flips move a
# hit between neighbouring triangles (4.1e-4 measured on an H100).
GRAD_RTOL = 5e-4


def card_name() -> str:
    """``name, power.limit`` of GPU 0 as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def box_scene(levels: int = 0) -> Scene:
    """The in-repo room (10 triangles + the default sphere), 4^levels-fold
    tessellated, with its accel."""
    base = scene_from_triangles_txt(BOX_SCENE)
    if not levels:
        return base
    tris, n = tessellate(base.triangles, base.n_triangles, levels=levels)
    return Scene.build(tris, base.spheres, base.env).replace(
        n_triangles=n, n_spheres=base.n_spheres
    ).with_accel()


def secondary_rays(scene: Scene, n: int, seed: int = 0):
    """``n`` seeded first-bounce rays: from the hit points of random 1080p
    primary rays, diffuse directions ``normalize(normal + unit)`` as the
    integrator draws them; primary rays that miss are replaced by rays from
    random points inside the room."""
    rng = np.random.default_rng(seed)
    o, d = primary_rays(Camera.look_at(), FRAME["width"], FRAME["height"])
    pick = jnp.asarray(rng.choice(o.shape[0], n, replace=False))
    o, d = o[pick], d[pick]
    hit = resolve_hit(o, d, _nearest_hit(o, d, scene, backend="xla"), scene)
    unit = rng.normal(size=(n, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    bounce = np.asarray(hit.normal) + unit
    bounce /= np.maximum(np.linalg.norm(bounce, axis=1, keepdims=True), 1e-12)
    interior = rng.uniform([-5.5, -5.5, -5.5], [5.5, 1.5, 5.5], (n, 3))
    hits = np.asarray(hit.hit)[:, None]
    o = np.where(hits, np.asarray(hit.point), interior)
    d = np.where(hits, bounce, unit)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _best_time(fn, repeats: int = 3) -> float:
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


_xla_search = jax.jit(_search_triangles_xla)
_nearest_hit = jax.jit(nearest_hit, static_argnames=("backend",))


def search_parity(scene: Scene, o, d, kernel: str = "triton") -> dict:
    """Compare the kernel's winners with the XLA scan's, ray by ray.

    The one allowed difference is a near tie: both searches hit, with
    distances within 2 ulp, where the two compilers may contract FMAs
    differently. The full search (spheres included) may differ only on rays
    whose triangle result already differed in some bit. ``mismatches``
    counts every other difference.
    """
    tris = scene.triangles
    dx, ix = _xla_search(o, d, tris)
    dk, ik = search_triangles_triton(
        o, d, tris, interpret=kernel == "triton-interpret"
    )
    dx, ix, dk, ik = (np.asarray(x) for x in (dx, ix, dk, ik))
    differ = ix != ik
    ulp = np.spacing(np.maximum(np.abs(dx), np.abs(dk)).astype(np.float32))
    near = differ & (ix >= 0) & (ik >= 0) & (np.abs(dx - dk) <= 2 * ulp)
    hx = _nearest_hit(o, d, scene, backend="xla")
    hk = _nearest_hit(o, d, scene, backend=kernel)
    full_differ = np.zeros(ix.shape, bool)
    for field in ("hit", "is_tri", "idx"):
        full_differ |= np.asarray(getattr(hx, field)) != np.asarray(
            getattr(hk, field)
        )
    wobble = differ | (dx != dk)
    bad = (differ & ~near) | (full_differ & ~wobble)
    for r in np.nonzero(bad)[0][:5]:
        print(f"  mismatch ray {r}: o {np.asarray(o[r]).tolist()} d "
              f"{np.asarray(d[r]).tolist()} xla ({ix[r]}, {dx[r]!r}) kernel "
              f"({ik[r]}, {dk[r]!r})", file=sys.stderr)
    return dict(
        rays=int(ix.size), hits=int((ix >= 0).sum()),
        near_ties=int(near.sum()), mismatches=int(bad.sum()),
        dst_bits_differ=int((~differ & (dx != dk)).sum()),
        full_differ=int(full_differ.sum()),
    )


def time_search(o, d, tris, kernel: str = "triton") -> dict:
    """Both searches alone, in turns XLA, kernel, kernel, XLA (seconds)."""
    fns = {
        "xla": lambda: _xla_search(o, d, tris),
        "kernel": lambda: search_triangles_triton(
            o, d, tris, interpret=kernel == "triton-interpret"
        ),
    }
    times = {"xla": [], "kernel": []}
    for name in ("xla", "kernel", "kernel", "xla"):
        times[name].append(_best_time(fns[name]))
    return times


def phase_search(kernel: str = "triton") -> str:
    cam = Camera.look_at()
    primary = primary_rays(cam, FRAME["width"], FRAME["height"])
    parts = []
    for levels in (4, 6):
        scene = box_scene(levels)
        secondary = secondary_rays(scene, 65536)
        for label, (o, d) in (("primary", primary), ("secondary", secondary)):
            p = search_parity(scene, o, d, kernel)
            if p["mismatches"]:
                raise AssertionError(
                    f"search parity, {scene.n_triangles} triangles, {label} "
                    f"rays: {p}"
                )
            t = time_search(o, d, scene.triangles, kernel)
            parts.append(
                f"{scene.n_triangles} tris {label} {p['rays']} rays "
                f"{p['hits']} hits near_ties {p['near_ties']} mismatches 0 "
                f"dst_bits_differ {p['dst_bits_differ']} full_differ "
                f"{p['full_differ']}, "
                f"search s xla {t['xla']} kernel {t['kernel']}"
            )
    return "; ".join(parts)


def resolve_exactness(scene: Scene, o, d, kernel: str = "triton") -> int:
    """The one-hot matmul gather of the resolve equals ``jnp.take`` bit for
    bit (up to the sign of zero), for the triangle and sphere tables of a scene small enough to take
    the one-hot path, at the search's winners and at every row. Returns the
    number of rows compared."""
    ref = _nearest_hit(o, d, scene, backend=kernel)
    tri_idx = jnp.where(ref.hit & ref.is_tri, ref.idx, 0)
    sph_idx = jnp.where(ref.hit & ~ref.is_tri, ref.idx, 0)
    take = jax.jit(lambda t, i: jnp.take(t, i, axis=0))
    onehot = jax.jit(gather_rows)
    compared = 0
    for table, idx in (
        (triangle_table(scene.triangles), tri_idx),
        (sphere_table(scene.spheres), sph_idx),
    ):
        idx = jnp.concatenate(
            [idx, jnp.arange(table.shape[0], dtype=jnp.int32)]
        )
        # The one-hot sum turns -0.0 entries into +0.0 (-0 + 0 = +0), an
        # inert difference; adding 0.0 folds both sides' zero signs.
        a = (np.asarray(onehot(table, idx)) + 0.0).view(np.uint32)
        b = (np.asarray(take(table, idx)) + 0.0).view(np.uint32)
        if not np.array_equal(a, b):
            raise AssertionError(
                f"one-hot resolve differs from jnp.take in "
                f"{int((a != b).any(axis=1).sum())} of {a.shape[0]} rows "
                f"of a {table.shape} table"
            )
        compared += a.shape[0]
    return compared


def phase_resolve(kernel: str = "triton") -> str:
    scene = box_scene(0)
    o, d = primary_rays(Camera.look_at(), FRAME["width"], FRAME["height"])
    so, sd = secondary_rays(scene, 65536, seed=1)
    rows = resolve_exactness(
        scene, jnp.concatenate([o, so]), jnp.concatenate([d, sd]), kernel
    )
    return f"one-hot resolve == jnp.take bitwise on {rows} gathered rows"


def frame_agreement(img, count, ref, ref_count) -> dict:
    """How far a frame is from a reference frame, by the measures above;
    ``ok`` says whether the two agree."""
    img, ref = np.asarray(img), np.asarray(ref)
    pix = (np.abs(img - ref) / np.maximum(np.abs(ref), 1.0)).max(axis=-1)
    r = dict(
        pixels_over=int((pix > FRAME_TOL).sum()),
        max_rel_diff=float(pix.max()),
        rays=float(count), ref_rays=float(ref_count),
        mean_rel_diff=abs(float(img.mean()) / float(ref.mean()) - 1.0),
    )
    r["ok"] = (r["pixels_over"] <= PIXEL_FRACTION * pix.size
               and abs(r["rays"] - r["ref_rays"]) <= COUNT_RTOL * r["ref_rays"]
               and r["mean_rel_diff"] <= MEAN_RTOL)
    return r


def production_frame(scene: Scene, kernel: str = "triton", **frame) -> dict:
    """Render one frame with the kernel and with XLA, in turns XLA, kernel,
    kernel, XLA; returns compile and warm (best of 2) seconds.

    Checks a finite image, a kernel frame bitwise equal under half the pixel
    chunk, and agreement with XLA (:func:`frame_agreement`)."""
    cam = Camera.look_at()

    def run(backend, **kw):
        img, count = render(scene, cam, seed=0, backend=backend, **frame,
                            **kw)
        jax.block_until_ready(img)
        return img, count

    out, compile_s, warm_s = {}, {}, {"xla": [], kernel: []}
    for backend in ("xla", kernel, kernel, "xla"):
        if backend not in out:
            t0 = time.perf_counter()
            out[backend] = run(backend)
            compile_s[backend] = time.perf_counter() - t0
        warm_s[backend].append(_best_time(lambda: run(backend)[0], 2))
    (img_x, count_x), (img_k, count_k) = out["xla"], out[kernel]
    img_x, img_k = np.asarray(img_x), np.asarray(img_k)
    if not np.isfinite(img_k).all() or float(count_k) <= 0:
        raise AssertionError("frame not finite or no rays traced")
    n_pix = img_k.shape[0] * img_k.shape[1]
    default_chunk = min(-(-n_pix // 1024) * 1024, 65536)  # render's own
    half = max(default_chunk // 2, 1024)
    img_h, count_h = run(kernel, pixel_chunk=half)
    if not np.array_equal(np.asarray(img_h), img_k) or count_h != count_k:
        raise AssertionError("kernel frame changes with the pixel chunk")
    agree = frame_agreement(img_k, count_k, img_x, count_x)
    if not agree["ok"]:
        raise AssertionError(f"kernel frame vs XLA of {n_pix} pixels: {agree}")
    return dict(
        rays=float(count_k), vs_xla=agree,
        compile_s={k: v - min(warm_s[k]) for k, v in compile_s.items()},
        warm_s=warm_s,
    )


def phase_frame(card: str, kernel: str = "triton") -> str:
    scene = box_scene(4)
    r = production_frame(scene, kernel, **FRAME)
    warm = min(r["warm_s"][kernel])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    return (
        f"[{card}] {FRAME['width']}x{FRAME['height']} spp {FRAME['spp']} "
        f"b {FRAME['max_bounce']}, {scene.n_triangles} tris: compile s "
        f"{r['compile_s']}, warm frame s {r['warm_s']}, {r['rays']:.0f} rays, "
        f"{r['rays'] / warm:.6g} rays/s (kernel), kernel frame bitwise "
        f"equal at half the pixel chunk, vs xla {r['vs_xla']}, "
        f"peak_bytes_in_use {peak}"
    )


def cli_render(size: int, spp: int, bounces: int, backend: str = "auto"):
    """Render the room through the CLI into a temporary BMP; return it."""
    from raytracingc_tpu.cli import main as cli_main
    from raytracingc_tpu.render.image import read_bmp

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "cli.bmp")
        rc = cli_main([
            "--triangles", BOX_SCENE, "-s", str(size), str(size),
            "--spp", str(spp), "-b", str(bounces), "--backend", backend,
            "-o", out,
        ])
        if rc != 0:
            raise AssertionError(f"cli exited with {rc}")
        img = read_bmp(out)
    if img.shape != (size, size, 3):
        raise AssertionError(f"cli image shape {img.shape}")
    mean = img.reshape(-1, 3).mean(axis=0)
    # A lit room: neither black nor blown out, the teal floor and warm walls
    # keep every channel well inside (0, 255).
    if not ((mean > 20).all() and (mean < 235).all()):
        raise AssertionError(f"implausible cli image mean colour {mean}")
    return img


def phase_cli() -> str:
    img = cli_render(128, 64, 10)
    return f"128x128 BMP, mean colour {img.reshape(-1, 3).mean(axis=0)}"


def fit_check(scene: Scene, size: int, spp: int, bounces: int, steps: int,
              kernel: str = "triton") -> dict:
    """``fit_scene`` takes ``steps`` vertex steps from a displaced start;
    one step's vertex gradient is compared with the XLA search's."""
    from raytracingc_tpu.diff.optimize import fit_scene
    from raytracingc_tpu.render.integrator import trace_accumulate

    cam = Camera.look_at()
    target, _ = render(scene, cam, size, size, spp=spp, max_bounce=bounces,
                       seed=1, backend=kernel, early_exit=False)
    shift = jnp.array([0.0, 0.0, 0.02], jnp.float32)
    start = scene.replace(triangles=scene.triangles.replace(
        a=scene.triangles.a + shift, b=scene.triangles.b + shift,
        c=scene.triangles.c + shift,
    )).with_accel()
    vertices = ["triangles.a", "triangles.b", "triangles.c"]
    fitted, losses = fit_scene(
        start, target, cam, steps=steps, spp=spp, max_bounce=bounces,
        backend=kernel, trainable=vertices, learning_rate=1e-3,
    )
    moved = max(
        float(jnp.max(jnp.abs(getattr(fitted.triangles, v)
                              - getattr(start.triangles, v))))
        for v in ("a", "b", "c")
    )
    if not np.all(np.isfinite(losses)) or moved <= 0:
        raise AssertionError(f"fit: losses {losses}, vertex update {moved}")

    o, d = primary_rays(cam, size, size)
    ids = jnp.arange(size * size, dtype=jnp.uint32)
    tgt = target.reshape(-1, 3)

    def vertex_grad(backend):
        def loss(tris):
            rad, _ = trace_accumulate(
                o, d, start.replace(triangles=tris, accel=None), ids,
                seed=0, spp=spp, max_bounce=bounces, backend=backend,
            )
            return jnp.mean((rad - tgt) ** 2)

        g = jax.jit(jax.grad(loss))(start.triangles)
        return np.concatenate([np.asarray(g.a), np.asarray(g.b),
                               np.asarray(g.c)])

    g_k, g_x = vertex_grad(kernel), vertex_grad("xla")
    norm = float(np.linalg.norm(g_x))
    rel = float(np.linalg.norm(g_k - g_x)) / max(norm, 1e-30)
    if norm == 0 or not np.isfinite(g_k).all() or rel > GRAD_RTOL:
        raise AssertionError(
            f"vertex gradient: |g_xla| {norm}, relative difference {rel}"
        )
    return dict(losses=[float(x) for x in losses], moved=moved,
                grad_norm=norm, grad_rel_diff=rel)


def phase_fit(kernel: str = "triton") -> str:
    r = fit_check(box_scene(4), 256, 2, 4, 3, kernel)
    return (
        f"3 vertex steps at 256x256 spp 2 b 4: losses {r['losses']}, "
        f"vertex update {r['moved']}, |grad| {r['grad_norm']}, "
        f"|grad_kernel - grad_xla| / |grad_xla| {r['grad_rel_diff']}"
    )


def one_device_references(scene: Scene, train: dict, **frame) -> dict:
    """The one-device half of :func:`sharded_check`: the frame rendered by
    ``render`` in one chunk (the reference of the sharded layouts) and in
    its default pixel chunks, each with its warm time (best of 2, seconds),
    and the loss of one :func:`train_loss` step on a one-device mesh."""
    from raytracingc_tpu.parallel.mesh import make_mesh

    cam = Camera.look_at()
    out = {}
    for name, chunk in (("one chunk", frame["width"] * frame["height"]),
                        ("chunked", None)):
        img, count = render(scene, cam, seed=0, pixel_chunk=chunk, **frame)
        out[name] = (np.asarray(img), float(count))
        out[f"{name} s"] = _best_time(lambda: render(
            scene, cam, seed=0, pixel_chunk=chunk, **frame)[0], 2)

    out["loss"] = train_loss(scene, make_mesh(px=1, spp=1), **train)
    return out


def train_loss(scene: Scene, mesh, width: int, height: int, spp: int,
               max_bounce: int) -> float:
    """The loss of one ``make_train_step`` step on ``mesh``, fitting the
    frame to 0.9 times its render under another seed."""
    import optax

    from raytracingc_tpu.parallel.sharded import make_train_step

    cam = Camera.look_at()
    o, d = primary_rays(cam, width, height)
    ids = jnp.arange(width * height, dtype=jnp.uint32)
    target, _ = render(scene, cam, width, height, spp=spp,
                       max_bounce=max_bounce, seed=1)
    opt = optax.adam(1e-3)
    step = make_train_step(mesh, opt, spp=spp, max_bounce=max_bounce, seed=7)
    state = opt.init(scene.replace(accel=None))
    _, _, loss = step(scene, state, o, d, ids, target.reshape(-1, 3) * 0.9)
    return float(loss)


def sharded_check(scene: Scene, n: int, train: dict, **frame) -> dict:
    """``render_sharded`` (pixels, samples, pixels with block-sharded
    triangles) on ``n`` devices against the one-device frame rendered in one
    chunk: equal ray counts, radiance within ``SHARD_TOL``. One
    ``make_train_step`` step on a (px=n/2, spp=2) mesh against the same step
    on one device, on the smaller ``train`` frame: loss within 1e-5. Also
    reports, and bounds by :func:`frame_agreement`, how the default-chunked
    one-device frame differs from the one-chunk frame. Returns every
    comparison and each frame's warm time (best of 2, seconds); raises
    after all ran if any fails."""
    from raytracingc_tpu.parallel.mesh import make_mesh
    from raytracingc_tpu.parallel.sharded import (
        pad_scene_for_blocks,
        render_sharded,
    )

    cam = Camera.look_at()
    refs = one_device_references(scene, train, **frame)
    ref, ref_count = refs["one chunk"]
    out = {k: refs[k] for k in ("one chunk s", "chunked s")}
    out["chunked vs one chunk"] = frame_agreement(*refs["chunked"], ref,
                                                  ref_count)
    bad = [] if out["chunked vs one chunk"]["ok"] else ["chunked"]
    for strategy, layout in (("pixels", "replicated"),
                             ("samples", "replicated"),
                             ("pixels", "blocks")):
        s = pad_scene_for_blocks(scene, n) if layout == "blocks" else scene
        img, c = render_sharded(s, cam, seed=0, strategy=strategy,
                                scene_sharding=layout, **frame)
        rel = float((np.abs(np.asarray(img) - ref)
                     / np.maximum(np.abs(ref), 1.0)).max())
        key = f"{strategy}/{layout}"
        out[key] = dict(max_rel_diff=rel, rays=float(c), ref_rays=ref_count)
        if rel > SHARD_TOL or float(c) != ref_count:
            bad.append(key)
        out[f"{key} s"] = _best_time(
            lambda: render_sharded(s, cam, seed=0, strategy=strategy,
                                   scene_sharding=layout, **frame)[0], 2)

    loss = train_loss(scene, make_mesh(px=n // 2, spp=2), **train)
    out["train_loss_rel_diff"] = abs(loss - refs["loss"]) / abs(refs["loss"])
    if not np.isfinite(loss) or out["train_loss_rel_diff"] > 1e-5:
        bad.append("train step")
    if bad:
        raise AssertionError(f"sharded vs one device, {bad}: {out}")
    return out


def phase_four_cards(card: str) -> str:
    if len(jax.devices()) != 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found "
                             f"{len(jax.devices())}")
    r = sharded_check(box_scene(4), 4, **FRAME,
                      train=dict(width=256, height=256, spp=4, max_bounce=4))
    return f"[{card}] 4-card sharded render and train step vs one card: {r}"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-GPU sharded paths")
    args = parser.parse_args(argv)

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {platform!r}",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    devices = jax.devices()
    card = card_name()
    print(f"device: jax {jax.__version__}, {devices[0].device_kind} x "
          f"{len(devices)}, card {card}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache}",
          flush=True)
    if args.four_cards:
        phases = [("four cards", lambda: phase_four_cards(card))]
    else:
        phases = [
            ("search", phase_search),
            ("resolve", phase_resolve),
            ("frame", lambda: phase_frame(card)),
            ("cli", phase_cli),
            ("fit", phase_fit),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        line = run()
        print(f"{name} ({time.perf_counter() - t0:.1f} s): {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
