"""Block-AABB accel: a Morton permutation with exact block bounds that
never changes what the search or the render returns."""

import numpy as np
import pytest

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.ops.accel import build_accel
from raytracingc_tpu.ops.intersect import nearest_hit
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.scene.builder import scene_from_triangles_txt, tessellate
from raytracingc_tpu.scene.types import Scene


@pytest.fixture(scope="module")
def suzanne(box_scene_path):
    """The in-repo room tessellated to 640 triangles (5 accel blocks)."""
    base = scene_from_triangles_txt(box_scene_path)
    tris, n = tessellate(base.triangles, base.n_triangles, levels=3)
    return Scene.build(tris, base.spheres, base.env).replace(
        n_triangles=n, n_spheres=base.n_spheres
    ).with_accel()


@pytest.fixture(scope="module")
def rays(suzanne):
    cam = Camera.look_at()
    o, d = primary_rays(cam, 24, 24)
    return o, d


def test_accel_preserves_geometry(suzanne):
    """The permutation is a bijection over live triangles; AABBs bound them."""
    acc = suzanne.accel
    t_live = suzanne.n_triangles
    orig = np.asarray(acc.orig_idx)[:t_live]
    assert sorted(orig.tolist()) == list(range(t_live))
    # Every permuted vertex lies inside its block's AABB.
    a = np.asarray(acc.triangles.a)
    for blk in range(t_live // 128 + (1 if t_live % 128 else 0)):
        s, e = blk * 128, min((blk + 1) * 128, t_live)
        lo, hi = np.asarray(acc.aabb_lo[blk]), np.asarray(acc.aabb_hi[blk])
        assert (a[s:e] >= lo - 1e-5).all() and (a[s:e] <= hi + 1e-5).all()


def test_accel_search_matches_trivial(suzanne, rays):
    """An attached accel does not change the search: winners with and
    without it are identical (original-order indices)."""
    o, d = rays
    with_acc = nearest_hit(o, d, suzanne, backend="triton-interpret")
    without = nearest_hit(o, d, suzanne.replace(accel=None),
                          backend="triton-interpret")
    for field in ("hit", "is_tri", "idx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(with_acc, field)),
            np.asarray(getattr(without, field)), err_msg=field,
        )
    assert np.asarray(with_acc.hit).sum() > 100


def test_accel_matches_xla_backend(suzanne, rays):
    o, d = rays
    ref_p = nearest_hit(o, d, suzanne, backend="triton-interpret")
    ref_x = nearest_hit(o, d, suzanne, backend="xla")
    np.testing.assert_array_equal(np.asarray(ref_p.hit), np.asarray(ref_x.hit))
    np.testing.assert_array_equal(np.asarray(ref_p.idx), np.asarray(ref_x.idx))


def test_render_with_and_without_accel(suzanne):
    cam = Camera.look_at()
    with_acc, _ = render(suzanne, cam, 12, 12, spp=2, max_bounce=2, seed=1,
                         backend="triton-interpret")
    plain = suzanne.replace(accel=None)
    without, _ = render(plain, cam, 12, 12, spp=2, max_bounce=2, seed=1,
                        backend="triton-interpret")
    np.testing.assert_array_equal(np.asarray(with_acc), np.asarray(without))


def test_build_accel_empty_padding_blocks():
    """Padding-only blocks must never hit (inverted AABB)."""
    from raytracingc_tpu.scene.builder import triangles_from_arrays

    verts = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    normals = np.array([[0, 0, 1]], np.float32)
    tris, n_live = triangles_from_arrays(
        verts, normals, np.ones((1, 3), np.float32),
        np.zeros(1, np.float32), np.zeros(1, np.float32), pad_to=256,
    )
    acc = build_accel(tris, n_live)
    assert acc.aabb_lo.shape == (2, 3)
    assert (np.asarray(acc.aabb_lo[1]) > np.asarray(acc.aabb_hi[1])).all()
