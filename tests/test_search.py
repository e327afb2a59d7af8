"""Closest-hit search: every implementation against a NumPy brute force.

Each case runs through ``nearest_hit`` with the XLA scan and with the GPU
kernel in the Pallas interpreter, and is checked against a float32 NumPy
oracle that follows ``ray_triangle_dst``'s operation order and the C scan's
tie rule (lowest index among equal distances; a sphere beats a triangle at
equal distance). Sizes stay small (≤1,024 rays, ≤512 triangles): the
interpreter runs the kernel one program at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.ops import intersect
from raytracingc_tpu.ops.intersect import (
    _search_triangles_xla,
    nearest_hit,
    resolve_backend,
)
from raytracingc_tpu.ops.search_triton import search_triangles_triton
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.scene.builder import tessellate, triangles_from_arrays
from raytracingc_tpu.scene.types import (
    EPSILON,
    MISS_DST,
    Scene,
    Spheres,
    Triangles,
)

IMPLS = ["xla", "triton-interpret"]


# ----------------------------------------------------------------------------
# Oracle and scene helpers.
# ----------------------------------------------------------------------------


def _dot(x, y):
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def _cross(x, y):
    return np.stack(
        [
            x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
            x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
            x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0],
        ],
        axis=-1,
    )


def oracle(o, d, scene):
    """(hit, is_tri, idx) per ray by brute force in float32 NumPy."""
    f32 = lambda x: np.asarray(x, np.float32)
    o, d = f32(o)[:, None], f32(d)[:, None]
    r = o.shape[0]
    t = scene.triangles
    if t.count:
        a, b, c, n = (f32(x)[None] for x in (t.a, t.b, t.c, t.normal))
        ab, ac = b - a, c - a
        h = _cross(d, ac)
        det = _dot(ab, h)
        degenerate = np.abs(det) < EPSILON
        inv = np.float32(1.0) / np.where(degenerate, np.float32(1.0), det)
        s = o - a
        u = _dot(s, h) * inv
        q = _cross(s, ab)
        v = _dot(d, q) * inv
        dst = _dot(ac, q) * inv
        valid = (
            (_dot(d, n) < 0) & ~degenerate & (u >= 0) & (u <= 1) & (v >= 0)
            & (u + v <= 1) & (dst >= EPSILON)
        )
        dst = np.where(valid, dst, np.float32(MISS_DST))
        tri_dst, tri_idx = dst.min(axis=1), dst.argmin(axis=1)
    else:
        tri_dst = np.full(r, MISS_DST, np.float32)
        tri_idx = np.zeros(r, np.int64)
    sph = scene.spheres
    if scene.n_spheres:
        cen, rad = f32(sph.center)[None], f32(sph.radius)[None]
        off = o - cen
        bq = _dot(off, d)
        delta = bq * bq - (_dot(off, off) - rad * rad)
        sq = np.sqrt(np.where(delta < 0, np.float32(0), delta))
        near, far = -bq - sq, -bq + sq
        sd = np.where(near < EPSILON, far, near)
        sd = np.where((delta >= 0) & (sd >= EPSILON) & (rad > 0), sd,
                      np.float32(MISS_DST))
        sph_dst, sph_idx = sd.min(axis=1), sd.argmin(axis=1)
    else:
        sph_dst = np.full(r, MISS_DST, np.float32)
        sph_idx = np.zeros(r, np.int64)
    is_tri = tri_dst < sph_dst
    best = np.where(is_tri, tri_dst, sph_dst)
    hit = best < MISS_DST
    idx = np.where(hit, np.where(is_tri, tri_idx, sph_idx), -1)
    return hit, is_tri, idx


def _ccw_normals(verts):
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    return (nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                             1e-20)).astype(np.float32)


def _raw_triangles(verts, normals):
    """Triangles WITHOUT the builder's padding (any count)."""
    t = verts.shape[0]
    return Triangles.from_numpy(
        verts.astype(np.float32), normals.astype(np.float32),
        np.full((t, 3), 0.5, np.float32), np.zeros(t, np.float32),
        np.zeros(t, np.float32),
    )


def _soup_verts(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, (n, 3))
    b = a + rng.uniform(-0.8, 0.8, (n, 3))
    c = a + rng.uniform(-0.8, 0.8, (n, 3))
    return np.stack([a, b, c], axis=1).astype(np.float32)


def _rays(r, seed, spread=5.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _spheres(centers, radii):
    s = len(radii)
    return Spheres(
        center=jnp.asarray(np.asarray(centers, np.float32)),
        radius=jnp.asarray(np.asarray(radii, np.float32)),
        albedo=jnp.ones((s, 3), jnp.float32),
        emission=jnp.zeros((s,), jnp.float32),
        smoothness=jnp.zeros((s,), jnp.float32),
    )


def _scene(tris, spheres=None):
    sph = spheres if spheres is not None else Spheres.empty()
    return Scene.build(tris, sph)


# ----------------------------------------------------------------------------
# Cases: (scene, origins, dirs, alive).
# ----------------------------------------------------------------------------


def case_ragged_rays():
    """300 triangles (builder-padded to 384); 77 rays — not a multiple of
    the kernel's ray block."""
    verts = _soup_verts(300, seed=1)
    tris, _ = triangles_from_arrays(
        verts, _ccw_normals(verts), np.full((300, 3), 0.5, np.float32),
        np.zeros(300, np.float32), np.zeros(300, np.float32),
    )
    o, d = _rays(77, seed=2)
    return _scene(tris), o, d, None


def case_ragged_triangles():
    """45 unpadded triangles — not a multiple of the triangle block."""
    verts = _soup_verts(45, seed=3)
    o, d = _rays(200, seed=4)
    return _scene(_raw_triangles(verts, _ccw_normals(verts))), o, d, None


def case_exact_ties():
    """Duplicated triangles (lowest index wins) and a sphere touching a
    triangle's plane at the same distance (the sphere wins)."""
    quad = np.array([[[-4, -4, 2], [4, -4, 2], [-4, 4, 2]],
                     [[4, -4, 2], [4, 4, 2], [-4, 4, 2]]], np.float32)
    far = quad + np.array([0, 0, 3], np.float32)
    # indices: 0 far, 1-2 quad, 3 far, 4-5 quad (duplicates of 1-2)
    verts = np.concatenate([far[:1], quad, far[1:], quad])
    normals = np.tile(np.array([[0, 0, -1]], np.float32), (len(verts), 1))
    spheres = _spheres([[10.0, 10.0, 3.0]], [1.0])  # z=2 at (10, 10)
    rng = np.random.default_rng(5)
    xy = rng.uniform(-3.5, 3.5, (120, 2))
    o = np.concatenate(
        [np.concatenate([xy, np.zeros((120, 1))], axis=1),
         [[10.0, 10.0, 0.0]]]
    ).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (len(o), 1))
    # a triangle in the sphere's tangent plane z=2, under the sphere
    tan = np.array([[[8, 8, 2], [16, 8, 2], [8, 16, 2]]], np.float32)
    verts = np.concatenate([verts, tan])
    normals = np.concatenate([normals, [[0, 0, -1]]]).astype(np.float32)
    return (_scene(_raw_triangles(verts, normals), spheres),
            jnp.asarray(o), jnp.asarray(d), None)


def case_backface_degenerate():
    """Backfacing (flipped normal: culled from the front, hit from behind)
    and zero-area triangles (never hit)."""
    verts = _soup_verts(64, seed=6)
    normals = _ccw_normals(verts)
    normals[::3] *= -1.0  # backfaces
    verts[1::5, 2] = verts[1::5, 0]  # C == A: degenerate
    o, d = _rays(300, seed=7)
    return _scene(_raw_triangles(verts, normals)), o, d, None


def case_all_dead():
    verts = _soup_verts(64, seed=8)
    o, d = _rays(100, seed=9)
    return (_scene(_raw_triangles(verts, _ccw_normals(verts))), o, d,
            jnp.zeros((100,), bool))


def case_partly_dead():
    verts = _soup_verts(96, seed=10)
    o, d = _rays(150, seed=11)
    alive = jnp.asarray(np.arange(150) % 3 != 1)
    return _scene(_raw_triangles(verts, _ccw_normals(verts))), o, d, alive


def case_sphere_only():
    spheres = _spheres([[0, 0, 0], [2, 1, 0], [-2, 0, 1]], [1.0, 0.5, 0.8])
    o, d = _rays(200, seed=12)
    return _scene(Triangles.empty(), spheres), o, d, None


CASES = {
    "ragged_rays": case_ragged_rays,
    "ragged_triangles": case_ragged_triangles,
    "exact_ties": case_exact_ties,
    "backface_degenerate": case_backface_degenerate,
    "all_dead": case_all_dead,
    "partly_dead": case_partly_dead,
    "sphere_only": case_sphere_only,
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", IMPLS)
def test_search_matches_oracle(impl, case):
    scene, o, d, alive = CASES[case]()
    got = nearest_hit(o, d, scene, backend=impl, alive=alive)
    hit, is_tri, idx = oracle(o, d, scene)
    live = np.ones(o.shape[0], bool) if alive is None else np.asarray(alive)
    np.testing.assert_array_equal(np.asarray(got.hit)[live], hit[live])
    np.testing.assert_array_equal(
        np.asarray(got.is_tri)[live & hit], is_tri[live & hit]
    )
    np.testing.assert_array_equal(np.asarray(got.idx)[live], idx[live])
    if impl != "xla":  # the kernel reports dead lanes as misses
        assert not np.asarray(got.hit)[~live].any()
    if case not in ("all_dead", "backface_degenerate"):
        assert hit[live].any()  # the comparison is not vacuous


def test_exact_tie_case_exercises_the_rules():
    """The tie case really has equal distances: duplicates resolve to the
    lower copy, and the sphere beats the triangle in its tangent plane."""
    scene, o, d, _ = case_exact_ties()
    hit, is_tri, idx = oracle(o, d, scene)
    assert set(idx[:-1][hit[:-1]].tolist()) <= {1, 2}
    assert hit[-1] and not is_tri[-1] and idx[-1] == 0


def test_degenerate_triangles_never_win():
    scene, o, d, _ = case_backface_degenerate()
    for impl in IMPLS:
        got = np.asarray(nearest_hit(o, d, scene, backend=impl).idx)
        assert not np.isin(got, np.arange(1, 64, 5)).any()


@pytest.mark.parametrize("impl", IMPLS)
def test_search_under_shard_map_blocks(impl):
    """Block-sharded triangles: each device searches its original-order
    shard, winners are globalized and lex-merged — equal to the oracle."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from raytracingc_tpu.parallel.sharded import (
        _scene_block_specs,
        mesh_for_strategy,
        pad_scene_for_blocks,
    )

    verts = _soup_verts(500, seed=13)
    tris, n = triangles_from_arrays(
        verts, _ccw_normals(verts), np.full((500, 3), 0.5, np.float32),
        np.zeros(500, np.float32), np.zeros(500, np.float32),
    )
    scene = pad_scene_for_blocks(
        Scene.build(tris, _spheres([[0, 0, 0]], [1.5])), 4
    )
    o, d = _rays(256, seed=14)
    mesh = mesh_for_strategy("pixels", 4)

    def shard_fn(s, o, d):
        return nearest_hit(o, d, s.replace(shard_axis="px"), backend=impl)

    got = jax.jit(shard_map(
        shard_fn, mesh=mesh, in_specs=(_scene_block_specs(scene), P(), P()),
        out_specs=P(), check_vma=False,
    ))(scene, o, d)
    hit, is_tri, idx = oracle(o, d, scene)
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    np.testing.assert_array_equal(np.asarray(got.idx), idx)
    np.testing.assert_array_equal(np.asarray(got.is_tri)[hit], is_tri[hit])
    assert hit.sum() > 20


@pytest.mark.parametrize(
    "blocks", [(32, 32), (16, 64), (64, 16)],
    ids=lambda b: "x".join(map(str, b)),
)
def test_kernel_tile_shapes_agree(blocks):
    """Results do not depend on the kernel's tile shape (ties included)."""
    ray_block, tri_block = blocks
    scene, o, d, _ = case_exact_ties()
    ref = search_triangles_triton(o, d, scene.triangles, interpret=True)
    got = search_triangles_triton(
        o, d, scene.triangles, interpret=True, ray_block=ray_block,
        tri_block=tri_block,
    )
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_kernel_distances_match_xla():
    scene, o, d, _ = case_ragged_rays()
    dk, ik = search_triangles_triton(o, d, scene.triangles, interpret=True)
    dx, ix = _search_triangles_xla(o, d, scene.triangles)
    np.testing.assert_array_equal(np.asarray(ik), np.asarray(ix))
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dx), rtol=1e-6)


# ----------------------------------------------------------------------------
# Dispatch.
# ----------------------------------------------------------------------------


@pytest.mark.parametrize(
    "platform, expect", [("gpu", "triton"), ("cpu", "xla")]
)
def test_auto_backend_per_platform(monkeypatch, platform, expect):
    monkeypatch.setattr(intersect.jax, "default_backend", lambda: platform)
    assert resolve_backend("auto") == expect


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_auto_backend_unknown_platform_raises(monkeypatch, platform):
    monkeypatch.setattr(intersect.jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match="no search backend"):
        resolve_backend("auto")


@pytest.mark.parametrize("name", ["xla", "triton", "triton-interpret"])
def test_explicit_backend_names_pass_through(name):
    assert resolve_backend(name) == name


@pytest.mark.parametrize("name", ["pallas", "mxu", ""])
def test_unknown_backend_name_raises(name):
    with pytest.raises(ValueError, match="unknown search backend"):
        resolve_backend(name)


def test_no_interpret_fallback_off_card():
    """Off the card the compiled kernel fails loudly; only an explicit
    ``triton-interpret`` / ``interpret=True`` runs the interpreter."""
    assert jax.default_backend() == "cpu"
    scene, o, d, _ = case_ragged_rays()
    with pytest.raises(Exception, match="(?i)interpret"):
        search_triangles_triton(o, d, scene.triangles)
    with pytest.raises(Exception, match="(?i)interpret"):
        nearest_hit(o, d, scene, backend="triton")


# ----------------------------------------------------------------------------
# Gradients and geometry.
# ----------------------------------------------------------------------------


def test_render_gradient_matches_between_implementations(box_scene_path):
    """``jax.grad`` through ``render`` (differentiable scan) gives the same
    scene gradients with either search: winners are equal, and the search
    is outside the differentiated path."""
    from raytracingc_tpu.scene.builder import scene_from_triangles_txt

    scene = scene_from_triangles_txt(box_scene_path).replace(accel=None)
    cam = Camera.look_at()

    def loss(s, backend):
        img, _ = render(s, cam, 12, 12, spp=2, max_bounce=3, seed=4,
                        backend=backend, early_exit=False)
        return jnp.mean(img ** 2)

    grads = {b: jax.grad(loss)(scene, b) for b in IMPLS}
    for field in ("a", "albedo", "emission"):
        gx = np.asarray(getattr(grads["xla"].triangles, field))
        gk = np.asarray(getattr(grads["triton-interpret"].triangles, field))
        assert np.abs(gx).max() > 0, field
        np.testing.assert_allclose(gk, gx, rtol=1e-5, atol=1e-8,
                                   err_msg=field)


def test_tessellate_preserves_surface():
    """4-way midpoint subdivision: counts scale by 4^levels and the closest
    hit DISTANCE field is unchanged (the children tile the parent exactly);
    materials/normals are inherited."""
    verts = _soup_verts(64, seed=7)
    tris, n_live = triangles_from_arrays(
        verts, _ccw_normals(verts), np.full((64, 3), 0.5, np.float32),
        np.zeros(64, np.float32), np.zeros(64, np.float32),
    )
    t2, n2 = tessellate(tris, n_live, levels=2)
    assert n2 == 16 * n_live
    o, d = _rays(512, seed=8)
    d0, _ = _search_triangles_xla(o, d, tris)
    d2, _ = _search_triangles_xla(o, d, t2)
    # Distances agree to float roundoff (midpoints are exact in f32 halving,
    # but the MT arithmetic sees different vertex values).
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d2), rtol=2e-4)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel (no interpreter) against the XLA
    scan, ties and ragged shapes included."""
    for case in ("ragged_rays", "ragged_triangles", "exact_ties",
                 "partly_dead"):
        scene, o, d, alive = CASES[case]()
        got = nearest_hit(o, d, scene, backend="triton", alive=alive)
        ref = nearest_hit(o, d, scene, backend="xla", alive=alive)
        live = np.ones(o.shape[0], bool) if alive is None else np.asarray(alive)
        for field in ("hit", "idx"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, field))[live],
                np.asarray(getattr(ref, field))[live], err_msg=case,
            )
