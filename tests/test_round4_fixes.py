"""Round-4 regression tests (VERDICT r3 items).

Item 3: the differentiable fast forward — ``early_exit=False, compact=True``
runs the hit-front accumulator with a fixed-length compacted continuation:
forward values BIT-IDENTICAL to the production (early_exit) path, gradients
equal to the plain full-width scan oracle up to float re-association.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.render.integrator import trace_accumulate


@pytest.fixture(scope="module")
def demo_scene():
    from __graft_entry__ import _demo_scene

    return _demo_scene()


@pytest.fixture(scope="module")
def cam():
    return Camera.look_at()


@pytest.fixture(scope="module")
def wide_rays(cam):
    # r = 8192: wide enough to engage the compaction ladder (k0 >= 1024),
    # so the test exercises the packed row-gather + switch + inverse-perm
    # map-back under AD, not just the full-width branch.
    w, h = 128, 64
    origins, dirs = primary_rays(cam, w, h)
    ray_ids = jnp.arange(w * h, dtype=jnp.uint32)
    return origins, dirs, ray_ids


def test_diff_fast_forward_bitwise_equals_production(demo_scene, wide_rays):
    origins, dirs, ray_ids = wide_rays
    kw = dict(seed=7, spp=2, max_bounce=3)
    prod, c_prod = trace_accumulate(
        origins, dirs, demo_scene, ray_ids, early_exit=True, compact=True, **kw
    )
    dfast, c_dfast = trace_accumulate(
        origins, dirs, demo_scene, ray_ids, early_exit=False, compact=True, **kw
    )
    # Same hit-front selection, same association, same per-lane arithmetic:
    # only while_loop vs fixed-length scan differs, which is bit-identical.
    assert float(c_prod) == float(c_dfast)
    np.testing.assert_array_equal(np.asarray(prod), np.asarray(dfast))


def test_diff_fast_grads_match_plain_scan(demo_scene, wide_rays):
    origins, dirs, ray_ids = wide_rays
    kw = dict(seed=7, spp=2, max_bounce=3)
    plain, _ = trace_accumulate(
        origins, dirs, demo_scene, ray_ids,
        early_exit=False, compact=False, **kw
    )
    tgt = plain * 0.7 + 0.05  # off-minimum so gradients are O(1)

    def loss(s, compact):
        r, _ = trace_accumulate(
            origins, dirs, s, ray_ids,
            early_exit=False, compact=compact, **kw
        )
        return jnp.mean((r - tgt) ** 2)

    g_plain = jax.grad(lambda s: loss(s, False))(demo_scene)
    g_fast = jax.grad(lambda s: loss(s, True))(demo_scene)
    for name in ("albedo", "a", "emission"):
        gp = np.asarray(getattr(g_plain.triangles, name))
        gf = np.asarray(getattr(g_fast.triangles, name))
        assert np.isfinite(gf).all(), name
        np.testing.assert_allclose(gf, gp, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g_fast.env.sky_horizon),
        np.asarray(g_plain.env.sky_horizon), rtol=1e-3, atol=1e-7,
    )


def test_diff_fast_is_default_for_diff_callers(demo_scene, wide_rays):
    """trace_accumulate's defaults (early_exit=False, compact=True) must BE
    the diff-fast path — fit_scene/fit_camera/fd_check rely on defaults."""
    origins, dirs, ray_ids = wide_rays
    kw = dict(seed=7, spp=2, max_bounce=3)
    default, c_default = trace_accumulate(
        origins, dirs, demo_scene, ray_ids, **kw
    )
    prod, c_prod = trace_accumulate(
        origins, dirs, demo_scene, ray_ids, early_exit=True, compact=True, **kw
    )
    assert float(c_default) == float(c_prod)
    np.testing.assert_array_equal(np.asarray(default), np.asarray(prod))


# -----------------------------------------------------------------------------
# VERDICT r3 item 4: block-sharded scene buffers (SURVEY §5.8).
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def box_scene(box_scene_path):
    """Tessellated in-repo room: enough triangles that 8-way block sharding
    is non-trivial (160 live -> padded to 1024 = 8 blocks)."""
    from raytracingc_tpu.scene.builder import (
        scene_from_triangles_txt,
        tessellate,
    )
    from raytracingc_tpu.scene.types import Scene

    s0 = scene_from_triangles_txt(box_scene_path)
    tris, n = tessellate(s0.triangles, s0.n_triangles, levels=2)
    sc = Scene.build(triangles=tris, spheres=s0.spheres, env=s0.env)
    return sc.replace(n_triangles=n, n_spheres=s0.n_spheres).with_accel()


def test_pad_scene_for_blocks_is_inert(box_scene, cam):
    from raytracingc_tpu.parallel.sharded import pad_scene_for_blocks
    from raytracingc_tpu.render.renderer import render

    padded = pad_scene_for_blocks(box_scene, 8)
    assert padded.triangles.count % (8 * 128) == 0
    assert padded.n_triangles == box_scene.n_triangles
    a, ca = render(box_scene, cam, 16, 16, spp=2, max_bounce=3, seed=3)
    b, cb = render(padded, cam, 16, 16, spp=2, max_bounce=3, seed=3)
    assert float(ca) == float(cb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("strategy", ["pixels", "both"])
def test_block_sharded_render_bitwise_equals_replicated(
    box_scene, cam, strategy
):
    """SURVEY §5.8 'block-sharded with all_gather': triangle buffers 1/n per
    device must render BIT-IDENTICALLY to the replicated scene on the same
    mesh (the lex-merge of per-shard winners is min over a partition of the
    scan order; the psum payload combine adds only zeros)."""
    from raytracingc_tpu.parallel.sharded import (
        mesh_for_strategy,
        pad_scene_for_blocks,
        render_sharded,
    )

    mesh = mesh_for_strategy(strategy, 8)
    padded = pad_scene_for_blocks(box_scene, mesh.shape["px"])
    ref, c_ref = render_sharded(
        padded, cam, 16, 16, spp=2, max_bounce=3, seed=5, mesh=mesh,
    )
    img, c_sh = render_sharded(
        padded, cam, 16, 16, spp=2, max_bounce=3, seed=5, mesh=mesh,
        scene_sharding="blocks",
    )
    assert float(c_ref) == float(c_sh)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))


@pytest.mark.parametrize("layout", ["replicated", "blocks"])
def test_pixel_sharded_render_equals_one_chunk_render(box_scene, cam, layout):
    """Pixel sharding equals a single-device render of the whole frame in
    one chunk, bit for bit, ray count included. (A padded or multi-chunk
    render is another XLA program, whose arithmetic may differ by an ulp.)"""
    from raytracingc_tpu.parallel.sharded import (
        mesh_for_strategy,
        pad_scene_for_blocks,
        render_sharded,
    )
    from raytracingc_tpu.render.renderer import render

    padded = pad_scene_for_blocks(box_scene, 8)
    ref, c_ref = render(padded, cam, 16, 16, spp=2, max_bounce=3, seed=5,
                        pixel_chunk=16 * 16)
    img, c_sh = render_sharded(
        padded, cam, 16, 16, spp=2, max_bounce=3, seed=5,
        mesh=mesh_for_strategy("pixels", 8), scene_sharding=layout,
    )
    assert float(c_ref) == float(c_sh)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))


def test_block_sharded_pallas_backend_matches(box_scene, cam):
    """The Pallas search kernel (interpret mode on CPU) under block
    sharding: each shard searches its own original-order slice, and the
    merged winners equal the whole-scene search."""
    from raytracingc_tpu.parallel.sharded import (
        mesh_for_strategy,
        pad_scene_for_blocks,
        render_sharded,
    )
    from raytracingc_tpu.render.renderer import render

    mesh = mesh_for_strategy("pixels", 8)
    padded = pad_scene_for_blocks(box_scene, 8)
    ref, _ = render(padded, cam, 8, 8, spp=1, max_bounce=2, seed=1,
                    backend="triton-interpret")
    img, _ = render_sharded(
        padded, cam, 8, 8, spp=1, max_bounce=2, seed=1, mesh=mesh,
        scene_sharding="blocks", backend="triton-interpret",
    )
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))


def test_block_sharded_search_merge_exact(box_scene, cam):
    """The load-bearing exactness: the lex-merged per-shard SEARCH winners
    (hit flag, primitive kind, ORIGINAL index) are integer results and must
    equal a whole-scene search exactly — no floating-point caveat. (Radiance
    renders can additionally differ by the repo-wide ~1-ulp cross-program
    fusion wobble, since blocks mode inserts collectives into the resolve.)"""
    import jax
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from raytracingc_tpu.camera import primary_rays
    from raytracingc_tpu.ops.intersect import nearest_hit
    from raytracingc_tpu.parallel.sharded import (
        _scene_block_specs,
        mesh_for_strategy,
        pad_scene_for_blocks,
    )

    mesh = mesh_for_strategy("pixels", 8)
    padded = pad_scene_for_blocks(box_scene, 8)
    origins, dirs = primary_rays(cam, 16, 16)

    ref = nearest_hit(origins, dirs, padded)

    def shard_fn(scene, o, d):
        return nearest_hit(o, d, scene.replace(shard_axis="px"))

    got = jax.jit(
        shard_map(
            shard_fn, mesh=mesh,
            in_specs=(_scene_block_specs(padded), P(), P()),
            out_specs=P(), check_vma=False,
        )
    )(padded, origins, dirs)

    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(got.hit))
    np.testing.assert_array_equal(
        np.asarray(ref.is_tri), np.asarray(got.is_tri)
    )
    np.testing.assert_array_equal(np.asarray(ref.idx), np.asarray(got.idx))


def test_cli_scene_sharding_blocks(tmp_path, box_scene_path):
    """--shard pixels --scene-sharding blocks produces the same image as the
    unsharded render (bit-matched winners; tonemapped bytes within 1)."""
    from raytracingc_tpu.cli import main
    from raytracingc_tpu.render.image import read_bmp

    out1 = str(tmp_path / "plain.bmp")
    out2 = str(tmp_path / "blocks.bmp")
    scene = ["--triangles", box_scene_path]
    assert main(scene + ["-s", "8", "8", "--spp", "4", "-b", "2",
                         "-o", out1]) == 0
    assert main(scene + ["-s", "8", "8", "--spp", "4", "-b", "2",
                         "--shard", "pixels", "--scene-sharding", "blocks",
                         "-o", out2]) == 0
    np.testing.assert_allclose(
        read_bmp(out2).astype(np.int32), read_bmp(out1).astype(np.int32),
        atol=1,
    )


def test_pad_scene_for_blocks_non_multiple_count():
    """Review r4: a triangle count that is not a 128-multiple must round UP
    (floor-division computed a smaller target and crashed jnp.pad)."""
    import numpy as np_

    from raytracingc_tpu.parallel.sharded import pad_scene_for_blocks
    from raytracingc_tpu.scene.types import Scene, Spheres, Triangles

    n = 300
    rng_ = np_.random.default_rng(0)
    a = rng_.uniform(-1, 1, (n, 3)).astype(np_.float32)
    tris = Triangles(
        a=jnp.asarray(a), b=jnp.asarray(a + 0.1), c=jnp.asarray(a - 0.1),
        normal=jnp.asarray(a), albedo=jnp.ones((n, 3), jnp.float32),
        emission=jnp.zeros((n,), jnp.float32),
        smoothness=jnp.zeros((n,), jnp.float32),
    )
    scene = Scene.build(triangles=tris, spheres=Spheres.empty())
    padded = pad_scene_for_blocks(scene, 2)
    assert padded.triangles.count % (2 * 128) == 0
    assert padded.triangles.count >= n


def test_block_sharded_accel_free_pallas_matches(box_scene, cam):
    """Blocks mode WITHOUT an accel on the kernel backend: each shard
    numbers its LOCAL slice, so the merge must globalize the indices
    (duplicated local ids once collided and silently corrupted the image).
    It must match the single-device render."""
    from raytracingc_tpu.parallel.sharded import (
        mesh_for_strategy,
        pad_scene_for_blocks,
        render_sharded,
    )
    from raytracingc_tpu.render.renderer import render

    mesh = mesh_for_strategy("pixels", 8)
    padded = pad_scene_for_blocks(box_scene, 8).replace(accel=None)
    ref, _ = render(padded, cam, 8, 8, spp=1, max_bounce=2, seed=2,
                    backend="triton-interpret")
    img, _ = render_sharded(
        padded, cam, 8, 8, spp=1, max_bounce=2, seed=2, mesh=mesh,
        scene_sharding="blocks", backend="triton-interpret",
    )
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))


def test_cli_scene_sharding_requires_shard(tmp_path, box_scene_path):
    """--scene-sharding blocks without --shard must fail loudly instead of
    silently rendering the replicated configuration."""
    import pytest as pytest_

    from raytracingc_tpu.cli import main

    with pytest_.raises(SystemExit, match="scene-sharding"):
        main(["--triangles", box_scene_path, "-s", "8", "8", "--spp", "1",
              "-b", "1",
              "--scene-sharding", "blocks", "-o", str(tmp_path / "x.bmp")])
