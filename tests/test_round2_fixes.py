"""Round-2 regression tests: C9 debug-walk parity and stale-accel hazards.

Pins the fixes from the round-1 review:

* ``calcDebugColor`` has NO Russian roulette (``raytracing.c:242-260`` draws
  only the scatter direction) — the heatmap walk must not terminate paths
  stochastically.
* The accel carries a frozen geometry copy; training geometry (or replacing
  triangles) must not leave a stale accel attached to the scene.
"""

import os

import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.render.integrator import render_debug
from raytracingc_tpu.scene.types import Scene, Spheres, Triangles


def _mirror_corridor_scene() -> Scene:
    """Two huge dark mirrors facing each other: rays ping-pong forever.

    Smoothness 1 makes every scatter a pure specular reflection (the RNG draw
    is lerped away), so the walk is deterministic: every path alternates
    between the two planes for as many bounces as allowed.
    """
    from raytracingc_tpu.scene.builder import triangles_from_arrays

    s = 1000.0
    verts = np.array(
        [
            # z = +3 plane, normal -z (faces the camera at the origin).
            [[-s, -s, 3], [0, s, 3], [s, -s, 3]],
            # z = -3 plane, normal +z.
            [[-s, -s, -3], [s, -s, -3], [0, s, -3]],
        ],
        np.float32,
    )
    ab = verts[:, 1] - verts[:, 0]
    ac = verts[:, 2] - verts[:, 0]
    normals = np.cross(ab, ac)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    albedo = np.full((2, 3), 0.05, np.float32)  # roulette would kill ~all
    tris, _ = triangles_from_arrays(verts, normals, albedo,
                                    np.zeros(2, np.float32),
                                    np.ones(2, np.float32))
    return Scene.build(triangles=tris, spheres=Spheres.empty())


def test_debug_heatmap_has_no_roulette():
    """Between two mirrors every path must reach max_bounce.

    The C debug walk (``raytracing.c:242-260``) only ends on miss or at
    ``maxBounce`` — with albedo 0.05 a roulette (p ≈ 0.05 per bounce) would
    terminate essentially every path after the first hit, so a pure-white
    heatmap is a sharp discriminator.
    """
    scene = _mirror_corridor_scene()
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    img = np.asarray(render_debug(scene, cam, 16, 16, max_bounce=6, seed=0))
    np.testing.assert_array_equal(img, np.ones_like(img))


def test_sphere_only_scene_renders():
    """Zero-triangle scenes must not break either search backend."""
    from raytracingc_tpu.ops.intersect import intersect

    spheres = Spheres(
        center=jnp.array([[0.0, 0.0, 5.0]], jnp.float32),
        radius=jnp.array([1.0], jnp.float32),
        albedo=jnp.full((1, 3), 0.5, jnp.float32),
        emission=jnp.zeros((1,), jnp.float32),
        smoothness=jnp.zeros((1,), jnp.float32),
    )
    scene = Scene.build(triangles=Triangles.empty(), spheres=spheres)
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (8, 1))
    hit = intersect(o, d, scene, backend="xla")
    assert bool(hit.hit[0])
    np.testing.assert_allclose(float(hit.dst[0]), 4.0, rtol=1e-5)


def _two_tri_scene() -> Scene:
    from raytracingc_tpu.scene.builder import triangles_from_arrays

    # CCW winding so the camera at the origin looking +z sees front faces
    # (normal = cross(B-A, C-A) must point towards -z).
    verts = np.array(
        [
            [[-1, -1, 3], [0, 1, 3], [1, -1, 3]],
            [[-1, -1, 6], [0, 1, 6], [1, -1, 6]],
        ],
        np.float32,
    )
    ab = verts[:, 1] - verts[:, 0]
    ac = verts[:, 2] - verts[:, 0]
    normals = np.cross(ab, ac)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    albedo = np.array([[0.8, 0.2, 0.2], [0.2, 0.8, 0.2]], np.float32)
    tris, _ = triangles_from_arrays(verts, normals, albedo,
                                    np.zeros(2, np.float32),
                                    np.zeros(2, np.float32))
    return Scene.build(triangles=tris, spheres=Spheres.empty()).with_accel()


def test_with_triangles_invalidates_accel():
    """``with_triangles`` must not leave a stale accel on moved geometry;
    the search follows the live triangles either way."""
    from raytracingc_tpu.ops.intersect import _search_triangles_xla
    from raytracingc_tpu.ops.search_triton import search_triangles_triton

    scene = _two_tri_scene()
    # Move every vertex 2 units along +z (away from the camera).
    moved_tris = scene.triangles.replace(
        a=scene.triangles.a + jnp.array([0.0, 0.0, 2.0]),
        b=scene.triangles.b + jnp.array([0.0, 0.0, 2.0]),
        c=scene.triangles.c + jnp.array([0.0, 0.0, 2.0]),
    )
    moved = scene.with_triangles(moved_tris)
    assert moved.accel is None  # stale accel dropped

    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (8, 1))
    d_pal, _ = search_triangles_triton(o, d, moved.triangles, interpret=True)
    d_xla, _ = _search_triangles_xla(o, d, moved.triangles, chunk=moved.triangles.count)
    np.testing.assert_allclose(np.asarray(d_pal), np.asarray(d_xla), rtol=1e-6)
    # And the hit is at the moved depth (5), not the stale one (3).
    assert abs(float(d_pal[0]) - 5.0) < 1e-4

    rebuilt = scene.with_triangles(moved_tris, rebuild_accel=True)
    d_reb, _ = search_triangles_triton(
        o, d, rebuilt.triangles, interpret=True
    )
    np.testing.assert_allclose(np.asarray(d_reb), np.asarray(d_xla), rtol=1e-6)
    # The rebuilt accel bounds the MOVED triangles (far one now at z = 8).
    assert float(np.asarray(rebuilt.accel.aabb_hi)[0, 2]) == 8.0


def test_fit_scene_geometry_training_loss_accel(monkeypatch):
    """Geometry-trainable losses must never see STALE accel values.

    Round-2 contract: accel-free loss. Round-5 contract (VERDICT r4 item 2):
    the loss sees a REFRESHED accel — values regenerated in-trace from the
    current triangles on the static permutation (``refresh_accel``), never
    ``build_accel``'s frozen copy. Pinned here: geometry training attaches
    an accel whose permuted geometry tracks the live triangles; a scene
    without an accel still runs accel-free; material-only training reuses
    the frozen accel object untouched."""
    import raytracingc_tpu.diff.optimize as optimize_mod
    from raytracingc_tpu.render.integrator import trace_accumulate

    seen = []

    def recording_trace_accumulate(o, d, s, ids, **kw):
        seen.append(s)
        return trace_accumulate(o, d, s, ids, **kw)

    monkeypatch.setattr(optimize_mod, "trace_accumulate",
                        recording_trace_accumulate)

    scene = _two_tri_scene()
    assert scene.accel is not None
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    target = jnp.zeros((4, 4, 3), jnp.float32)

    # Geometry trainable (default trainable=None): refreshed accel in the
    # loss — its permuted geometry is a TRACED gather of the live triangles
    # (same values here: step 0, geometry not yet updated).
    fitted, losses = optimize_mod.fit_scene(
        scene, target, cam, steps=1, spp=1, max_bounce=1, learning_rate=0.0
    )
    assert len(seen) == 1 and seen[0].accel is not None
    assert fitted.accel is not None  # fresh-sorted on return

    # No accel on the scene: geometry training falls back to accel-free.
    seen.clear()
    optimize_mod.fit_scene(
        scene.replace(accel=None), target, cam, steps=1, spp=1,
        max_bounce=1, learning_rate=0.0,
    )
    assert len(seen) == 1 and seen[0].accel is None

    # Material-only: the frozen-accel reuse optimization is allowed.
    seen.clear()
    fitted2, _ = optimize_mod.fit_scene(
        scene, target, cam, steps=1, spp=1, max_bounce=1,
        learning_rate=0.0, trainable=["albedo"],
    )
    assert len(seen) == 1 and seen[0].accel is not None
    assert fitted2.accel is not None


def test_cli_shard_plus_checkpoint(models_dir, tmp_path):
    """``--shard`` composes with ``--checkpoint`` (the production config)."""
    from raytracingc_tpu.cli import main
    from raytracingc_tpu.render.image import read_bmp

    out = str(tmp_path / "both.bmp")
    ckpt = str(tmp_path / "both.npz")
    args = ["-i", os.path.join(models_dir, "simplest.obj"),
            "-s", "8", "8", "--spp", "4", "-b", "2", "--batch-spp", "2",
            "--shard", "pixels", "--checkpoint", ckpt, "-o", out]
    assert main(args) == 0
    img = read_bmp(out)
    assert img.shape == (8, 8, 3)
    assert os.path.exists(ckpt)

    # Plain sharded render of the same config agrees (same per-sample
    # radiances; averaging re-association only).
    out2 = str(tmp_path / "plain.bmp")
    assert main(["-i", os.path.join(models_dir, "simplest.obj"),
                 "-s", "8", "8", "--spp", "4", "-b", "2",
                 "--shard", "pixels", "-o", out2]) == 0
    np.testing.assert_allclose(
        read_bmp(out2).astype(np.int32), img.astype(np.int32), atol=1
    )


def test_early_exit_grad_raises_and_jvp_works():
    """Reverse-mode through the while_loop variant fails loudly (jax's own
    error names while_loop); forward-mode (jvp) must keep working — a
    custom_vjp guard used briefly in round 2 broke jvp and was removed."""
    import jax
    import jax.numpy as jnp
    import pytest

    from raytracingc_tpu.camera import Camera, primary_rays
    from raytracingc_tpu.render.integrator import trace_accumulate

    scene = _two_tri_scene().replace(accel=None)
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    o, d = primary_rays(cam, 4, 4)
    ids = jnp.arange(16, dtype=jnp.uint32)

    def loss(s):
        r, _ = trace_accumulate(o, d, s, ids, seed=0, spp=1, max_bounce=2,
                                early_exit=True)
        return jnp.sum(r)

    with pytest.raises(ValueError, match="while_loop"):
        jax.grad(loss)(scene)

    # Forward-mode works (while_loop has a JVP rule).
    tangent = jax.tree_util.tree_map(jnp.ones_like, scene)
    _, dot = jax.jvp(loss, (scene,), (tangent,))
    assert jnp.isfinite(dot)


def test_hit_front_accumulator_matches_scan():
    """The per-chunk hit-front compaction path (active at chunk >= 4096)
    agrees with the fixed-length scan: identical ray counts, radiance equal
    to float re-association."""
    from __graft_entry__ import _demo_scene
    from raytracingc_tpu.render.renderer import render

    scene = _demo_scene()
    cam = Camera.look_at()
    a, ca = render(scene, cam, 80, 80, spp=3, max_bounce=6, early_exit=False,
                   compact=False)
    b, cb = render(scene, cam, 80, 80, spp=3, max_bounce=6, compact=True)
    assert float(ca) == float(cb)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=3e-6, atol=3e-7)

    # Camera inside the box: full geometry coverage -> n_hit > R/4 -> the
    # cond takes the full-width branch (same association as compact).
    cam2 = Camera.look_at(origin=[0.0, -1.0, 0.0], target=[1.0, -1.0, 0.0])
    a2, c2 = render(scene, cam2, 80, 80, spp=2, max_bounce=4,
                    early_exit=False, compact=False)
    b2, c3 = render(scene, cam2, 80, 80, spp=2, max_bounce=4, compact=True)
    assert float(c2) == float(c3)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(b2),
                               rtol=3e-6, atol=3e-7)


def test_early_exit_render_is_chunking_invariant():
    """The production (early_exit) path must produce BITWISE-identical
    radiance under any pixel chunking — the property that keeps
    'sharded == single-device exactly' true regardless of per-shard chunk
    statistics (every width uses the light0*spp + sum(rest) association,
    and which cond branch runs cannot change per-lane values)."""
    from __graft_entry__ import _demo_scene
    from raytracingc_tpu.render.renderer import render

    scene = _demo_scene()
    cam = Camera.look_at()
    imgs = [
        np.asarray(render(scene, cam, 80, 80, spp=2, max_bounce=4,
                          pixel_chunk=c)[0])
        for c in (1024, 2048, 7168)
    ]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])


def test_fit_scene_mesh_material_training_keeps_accel():
    """The sharded (mesh) path must hand the accel-carrying scene to the
    train step for material-only training — a round-2 review found the
    accel was stripped before the loop so the reuse could never engage."""
    import jax
    from raytracingc_tpu.diff.optimize import fit_scene
    from raytracingc_tpu.parallel.mesh import make_mesh

    scene = _two_tri_scene()
    assert scene.accel is not None
    cam = Camera.look_at(origin=[0.0, 0.0, 0.0], target=[0.0, 0.0, 1.0])
    target = jnp.zeros((8, 8, 3), jnp.float32)
    mesh = make_mesh(px=len(jax.devices()), spp=1)
    fitted, losses = fit_scene(
        scene, target, cam, steps=1, spp=1, max_bounce=1,
        learning_rate=0.0, trainable=["albedo"], mesh=mesh,
    )
    assert fitted.accel is not None
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_onehot_resolve_matches_gather():
    """resolve_hit uses a one-hot matmul instead of a row-gather for
    tables of <= 256 rows (equal values; ``chip_smoke.py`` checks the bits
    on the card). Pin both code paths against each other by padding the
    same scene past the threshold."""
    import jax.numpy as jnp
    import numpy as np

    from raytracingc_tpu.camera import Camera, primary_rays
    from raytracingc_tpu.ops.intersect import nearest_hit, resolve_hit
    from raytracingc_tpu.scene.builder import scene_from_triangles_txt

    scene = scene_from_triangles_txt(
        os.path.join(os.path.dirname(__file__), "..", "examples",
                     "box_scene.txt")
    )
    assert scene.triangles.a.shape[0] <= 256  # one-hot path

    cam = Camera.look_at()
    o, d = primary_rays(cam, 24, 24)
    ref = nearest_hit(o, d, scene, backend="xla")
    hit_small = resolve_hit(o, d, ref, scene)

    # Same geometry, padded past the one-hot threshold -> gather path.
    tr = scene.triangles
    pad = 512 - tr.a.shape[0]
    pz3 = jnp.zeros((pad, 3), jnp.float32)
    pz1 = jnp.zeros((pad,), jnp.float32)
    tr_big = tr.replace(
        a=jnp.concatenate([tr.a, pz3]), b=jnp.concatenate([tr.b, pz3]),
        c=jnp.concatenate([tr.c, pz3]),
        normal=jnp.concatenate([tr.normal, pz3]),
        albedo=jnp.concatenate([tr.albedo, pz3]),
        emission=jnp.concatenate([tr.emission, pz1]),
        smoothness=jnp.concatenate([tr.smoothness, pz1]),
    )
    scene_big = scene.replace(triangles=tr_big, accel=None)
    hit_big = resolve_hit(o, d, ref, scene_big)
    for field in ("dst", "point", "normal", "albedo", "emission", "smoothness"):
        np.testing.assert_array_equal(
            np.asarray(getattr(hit_small, field)),
            np.asarray(getattr(hit_big, field)), err_msg=field)
