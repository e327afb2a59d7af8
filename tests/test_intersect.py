"""Intersection tests: analytic cases + XLA/Pallas-kernel search agreement."""

import numpy as np
import pytest

import jax.numpy as jnp

from raytracingc_tpu.ops.intersect import (
    nearest_hit,
    ray_sphere_dst,
    ray_triangle_dst,
    resolve_hit,
)
from raytracingc_tpu.scene.builder import triangles_from_arrays, default_spheres, pad_spheres
from raytracingc_tpu.scene.types import EPSILON, Scene, Spheres


def _tri_scene(verts, albedo=None, emission=None, smoothness=None, spheres=None):
    t = verts.shape[0]
    tris, n = triangles_from_arrays(
        verts,
        _ccw_normals(verts),
        albedo if albedo is not None else np.ones((t, 3), np.float32),
        emission if emission is not None else np.zeros(t, np.float32),
        smoothness if smoothness is not None else np.zeros(t, np.float32),
    )
    if spheres is None:
        sph, n_sph = pad_spheres(Spheres.empty(), pad_to=8), 0
        sph = sph[0]
    else:
        sph, n_sph = pad_spheres(spheres, pad_to=8)
    scene = Scene.build(tris, sph)
    return scene.replace(n_triangles=n, n_spheres=n_sph)


def _ccw_normals(verts):
    ab = verts[:, 1] - verts[:, 0]
    ac = verts[:, 2] - verts[:, 0]
    n = np.cross(ab, ac)
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


def test_ray_triangle_analytic():
    # Triangle in z=2 plane, normal -z (CCW from below), ray along +z: the
    # normal must oppose the ray for the backface cull to pass.
    a = jnp.array([-1.0, -1.0, 2.0])
    b = jnp.array([-1.0, 1.0, 2.0])
    c = jnp.array([1.0, -1.0, 2.0])
    n = jnp.array([0.0, 0.0, -1.0])
    o = jnp.array([-0.5, -0.5, 0.0])
    d = jnp.array([0.0, 0.0, 1.0])
    dst, valid = ray_triangle_dst(o, d, a, b, c, n)
    assert bool(valid) and float(dst) == pytest.approx(2.0, abs=1e-6)

    # Backface: flip the normal → culled even though geometry intersects
    # (``raytracing.c:189``).
    _, valid = ray_triangle_dst(o, d, a, b, c, -n)
    assert not bool(valid)

    # Outside barycentric range.
    o2 = jnp.array([5.0, 5.0, 0.0])
    _, valid = ray_triangle_dst(o2, d, a, b, c, n)
    assert not bool(valid)

    # Behind the origin (dst < EPSILON).
    o3 = jnp.array([-0.5, -0.5, 3.0])
    _, valid = ray_triangle_dst(o3, d, a, b, c, n)
    assert not bool(valid)


def test_ray_sphere_analytic():
    o = jnp.array([0.0, 0.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    dst, valid = ray_sphere_dst(o, d, jnp.zeros(3), jnp.float32(1.0))
    assert bool(valid) and float(dst) == pytest.approx(4.0, abs=1e-5)

    # Inside the sphere: near root < EPSILON → far root (``raytracing.c:174-176``).
    o2 = jnp.zeros(3)
    dst, valid = ray_sphere_dst(o2, d, jnp.zeros(3), jnp.float32(1.0))
    assert bool(valid) and float(dst) == pytest.approx(1.0, abs=1e-5)

    # Miss.
    o3 = jnp.array([0.0, 5.0, -5.0])
    _, valid = ray_sphere_dst(o3, d, jnp.zeros(3), jnp.float32(1.0))
    assert not bool(valid)

    # Padding spheres (radius 0) never hit, even for rays through the center.
    _, valid = ray_sphere_dst(o, d, jnp.zeros(3), jnp.float32(0.0))
    assert not bool(valid)


def test_nearest_hit_picks_closest_and_materials():
    # Two parallel triangles; the nearer one (z=1) must win over z=2.
    verts = np.array(
        [
            [[-2, -2, 2], [-2, 2, 2], [2, -2, 2]],
            [[-2, -2, 1], [-2, 2, 1], [2, -2, 1]],
        ],
        np.float32,
    )
    albedo = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    emission = np.array([0.0, 5.0], np.float32)
    scene = _tri_scene(verts, albedo=albedo, emission=emission)
    o = jnp.array([[-0.5, -0.5, 0.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
    ref = nearest_hit(o, d, scene, backend="xla")
    assert bool(ref.hit[0]) and int(ref.idx[0]) == 1
    hit = resolve_hit(o, d, ref, scene)
    assert float(hit.dst[0]) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(np.asarray(hit.albedo[0]), [0, 1, 0])
    assert float(hit.emission[0]) == 5.0
    np.testing.assert_allclose(np.asarray(hit.point[0]), [-0.5, -0.5, 1.0], atol=1e-6)


def test_sphere_beats_triangle_on_tie_and_distance():
    verts = np.array([[[-2, -2, 3], [-2, 2, 3], [2, -2, 3]]], np.float32)
    sph = default_spheres()  # center (0,1,0) r 2.5
    sph = Spheres(
        center=jnp.array([[0.0, 0.0, 2.0]], jnp.float32),
        radius=jnp.array([1.0], jnp.float32),
        albedo=jnp.array([[0.2, 0.2, 0.9]], jnp.float32),
        emission=jnp.array([0.0], jnp.float32),
        smoothness=jnp.array([0.0], jnp.float32),
    )
    scene = _tri_scene(verts, spheres=sph)
    o = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
    ref = nearest_hit(o, d, scene, backend="xla")
    hit = resolve_hit(o, d, ref, scene)
    assert bool(ref.hit[0]) and not bool(ref.is_tri[0])
    assert float(hit.dst[0]) == pytest.approx(1.0, abs=1e-5)  # sphere at z∈[1,3]
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, -1], atol=1e-5)


def _random_scene_and_rays(seed, n_tris=96, n_rays=200):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-3, 3, (n_tris, 1, 3)).astype(np.float32)
    verts = base + rs.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    scene = _tri_scene(verts.astype(np.float32))
    o = rs.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rs.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, jnp.asarray(o), jnp.asarray(d)


def test_pallas_matches_xla_interpret():
    """The Pallas search kernel (interpreter mode on CPU) agrees with the
    XLA search exactly."""
    scene, o, d = _random_scene_and_rays(0)
    ref_x = nearest_hit(o, d, scene, backend="xla")
    ref_p = nearest_hit(o, d, scene, backend="triton-interpret")
    np.testing.assert_array_equal(np.asarray(ref_x.hit), np.asarray(ref_p.hit))
    np.testing.assert_array_equal(np.asarray(ref_x.idx), np.asarray(ref_p.idx))


def test_pallas_matches_xla_multi_chunk():
    """Many triangle blocks; odd ray count (padding path)."""
    scene, o, d = _random_scene_and_rays(1, n_tris=300, n_rays=77)
    ref_x = nearest_hit(o, d, scene, backend="xla")
    ref_p = nearest_hit(o, d, scene, backend="triton-interpret")
    np.testing.assert_array_equal(np.asarray(ref_x.hit), np.asarray(ref_p.hit))
    np.testing.assert_array_equal(np.asarray(ref_x.idx), np.asarray(ref_p.idx))


def test_brute_force_numpy_crosscheck():
    """XLA search against a dead-simple numpy MT scan."""
    scene, o, d = _random_scene_and_rays(2, n_tris=64, n_rays=50)
    on, dn = np.asarray(o), np.asarray(d)
    tris = scene.triangles
    a = np.asarray(tris.a)[:64]
    b = np.asarray(tris.b)[:64]
    c = np.asarray(tris.c)[:64]
    n = np.asarray(tris.normal)[:64]

    best = np.full(50, 999999.0)
    best_i = np.full(50, -1)
    for r in range(50):
        for t in range(64):
            if np.dot(dn[r], n[t]) >= 0:
                continue
            ab, ac = b[t] - a[t], c[t] - a[t]
            h = np.cross(dn[r], ac)
            det = np.dot(ab, h)
            if abs(det) < EPSILON:
                continue
            inv = 1.0 / det
            s = on[r] - a[t]
            u = np.dot(s, h) * inv
            if u < 0 or u > 1:
                continue
            q = np.cross(s, ab)
            v = np.dot(dn[r], q) * inv
            if v < 0 or u + v > 1:
                continue
            dst = np.dot(ac, q) * inv
            if dst < EPSILON:
                continue
            if dst < best[r]:
                best[r], best_i[r] = dst, t
    ref = nearest_hit(o, d, scene, backend="xla")
    np.testing.assert_array_equal(np.asarray(ref.idx), best_i)
