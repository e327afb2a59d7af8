"""Scene assembly: loaders → padded, device-ready ``Scene`` pytrees.

Covers the reference's OBJ→renderer adapter (``loadOBJTriangles``,
``raytracing.c:100-147``): every imported OBJ triangle gets rotZ(180°) applied —
x and y of positions AND normals are negated, z kept — compensating Blender's
y-up vs the renderer's y-down convention. Also carries the hard-coded default
sphere list (``scene.h:17-19``: one white sphere at (0, 1, 0) with radius 2.5)
used only in ``triangles.txt`` mode (``trianglesOnly`` stays 0, ``main.c:113``).

Padding: triangle counts are padded up to a multiple of ``pad_to`` with all-zero
triangles (guaranteed misses — zero normal fails the backface test), and sphere
counts with radius-0 spheres (treated as misses). This keeps every downstream
shape static and a whole number of accel blocks.
"""

from __future__ import annotations

import numpy as np

from raytracingc_tpu.scene.obj_loader import load_obj
from raytracingc_tpu.scene.triangles_txt import load_triangles_txt
from raytracingc_tpu.scene.types import EnvParams, Scene, Spheres, Triangles


def default_spheres() -> Spheres:
    """The reference's hard-coded sphere list (``scene.h:17-19``)."""
    import jax.numpy as jnp

    return Spheres(
        center=jnp.array([[0.0, 1.0, 0.0]], jnp.float32),
        radius=jnp.array([2.5], jnp.float32),
        albedo=jnp.array([[1.0, 1.0, 1.0]], jnp.float32),
        emission=jnp.array([0.0], jnp.float32),
        smoothness=jnp.array([0.0], jnp.float32),
    )


def _pad_axis0(x: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def triangles_from_arrays(
    verts: np.ndarray,
    normals: np.ndarray,
    albedo: np.ndarray,
    emission: np.ndarray,
    smoothness: np.ndarray,
    pad_to: int = 128,
) -> tuple[Triangles, int]:
    """Build a padded ``Triangles`` SoA; returns (triangles, live_count)."""
    t = verts.shape[0]
    tp = _round_up(t, pad_to)
    return (
        Triangles.from_numpy(
            verts=_pad_axis0(np.asarray(verts, np.float32), tp),
            normals=_pad_axis0(np.asarray(normals, np.float32), tp),
            albedo=_pad_axis0(np.asarray(albedo, np.float32), tp),
            emission=_pad_axis0(np.asarray(emission, np.float32), tp),
            smoothness=_pad_axis0(np.asarray(smoothness, np.float32), tp),
        ),
        t,
    )


def _load_obj_arrays(path: str, verbose: bool, use_native: bool | None):
    """OBJ parse via the native C++ loader when built, Python otherwise."""
    if use_native is not False:
        from raytracingc_tpu.scene import native

        if native.available():
            return native.load_obj_native(path)
        if use_native:
            raise RuntimeError("native loader requested but not built")
    mesh = load_obj(path, verbose=verbose)
    return mesh.verts, mesh.normals, mesh.albedo, mesh.emission, mesh.smoothness


def scene_from_obj(
    path: str,
    env: EnvParams | None = None,
    pad_to: int = 128,
    verbose: bool = False,
    use_native: bool | None = None,
) -> Scene:
    """Load an OBJ scene. OBJ mode is triangles-only (``main.c:241``).

    ``use_native``: ``None`` auto-selects the C++ loader when its shared
    library is built (same parse contract, verified equal by tests);
    ``True`` requires it; ``False`` forces the pure-Python parser.
    """
    verts0, normals0, albedo, emission, smoothness = _load_obj_arrays(
        path, verbose, use_native
    )
    verts = verts0.copy()
    normals = normals0.copy()
    # rotZ(180°) import convention (``raytracing.c:118-135``).
    verts[:, :, 0] *= -1.0
    verts[:, :, 1] *= -1.0
    normals[:, 0] *= -1.0
    normals[:, 1] *= -1.0
    tris, n_live = triangles_from_arrays(
        verts, normals, albedo, emission, smoothness, pad_to=pad_to
    )
    scene = Scene.build(tris, _padded_empty_spheres(), env)
    return scene.replace(n_triangles=n_live, n_spheres=0).with_accel()


def scene_from_triangles_txt(
    path: str,
    env: EnvParams | None = None,
    include_default_spheres: bool = True,
    pad_to: int = 128,
    use_native: bool | None = None,
) -> Scene:
    """Load a triangles.txt scene; default mode includes the sphere list."""
    if use_native is not False:
        from raytracingc_tpu.scene import native

        if native.available():
            verts, normals, albedo, emission, smoothness = (
                native.load_triangles_txt_native(path)
            )
        elif use_native:
            raise RuntimeError("native loader requested but not built")
        else:
            verts, normals, albedo, emission, smoothness = load_triangles_txt(path)
    else:
        verts, normals, albedo, emission, smoothness = load_triangles_txt(path)
    tris, n_live = triangles_from_arrays(
        verts, normals, albedo, emission, smoothness, pad_to=pad_to
    )
    if include_default_spheres:
        spheres, n_sph = pad_spheres(default_spheres(), pad_to=8)
    else:
        spheres, n_sph = _padded_empty_spheres(), 0
    scene = Scene.build(tris, spheres, env)
    return scene.replace(n_triangles=n_live, n_spheres=n_sph).with_accel()


def _padded_empty_spheres(pad_to: int = 8) -> Spheres:
    import jax.numpy as jnp

    z3 = jnp.zeros((pad_to, 3), jnp.float32)
    z1 = jnp.zeros((pad_to,), jnp.float32)
    return Spheres(center=z3, radius=z1, albedo=z3, emission=z1, smoothness=z1)


def pad_spheres(spheres: Spheres, pad_to: int = 8) -> tuple[Spheres, int]:
    import jax.numpy as jnp

    s = spheres.count
    sp = _round_up(s, pad_to)
    pad1 = lambda x: jnp.pad(x, (0, sp - s))
    pad3 = lambda x: jnp.pad(x, ((0, sp - s), (0, 0)))
    return (
        Spheres(
            center=pad3(spheres.center),
            radius=pad1(spheres.radius),
            albedo=pad3(spheres.albedo),
            emission=pad1(spheres.emission),
            smoothness=pad1(spheres.smoothness),
        ),
        s,
    )


def pad_scene(scene: Scene, pad_to: int = 128) -> Scene:
    """Re-pad an existing scene (e.g. after editing triangle counts)."""
    tris, n_live = triangles_from_arrays(
        np.stack(
            [
                np.asarray(scene.triangles.a),
                np.asarray(scene.triangles.b),
                np.asarray(scene.triangles.c),
            ],
            axis=1,
        )[: scene.n_triangles],
        np.asarray(scene.triangles.normal)[: scene.n_triangles],
        np.asarray(scene.triangles.albedo)[: scene.n_triangles],
        np.asarray(scene.triangles.emission)[: scene.n_triangles],
        np.asarray(scene.triangles.smoothness)[: scene.n_triangles],
        pad_to=pad_to,
    )
    return scene.replace(triangles=tris, n_triangles=n_live)


def tessellate(
    tris: Triangles, n_live: int, levels: int = 1
) -> tuple[Triangles, int]:
    """Midpoint 4-way subdivision: ``n_live`` → ``4**levels * n_live`` tris.

    Children inherit the parent's stored normal and material, and their
    union covers exactly the parent's surface — a tessellated scene renders
    the same image as the original (the per-hit shading inputs are equal),
    which makes this the scale-up tool for exercising the search on scenes
    far past the bundled assets' ~4k triangles.
    """
    a = np.asarray(tris.a[:n_live], np.float32)
    b = np.asarray(tris.b[:n_live], np.float32)
    c = np.asarray(tris.c[:n_live], np.float32)
    nm = np.asarray(tris.normal[:n_live], np.float32)
    al = np.asarray(tris.albedo[:n_live], np.float32)
    em = np.asarray(tris.emission[:n_live], np.float32)
    sm = np.asarray(tris.smoothness[:n_live], np.float32)
    for _ in range(levels):
        ab, bc, ca = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
        # corner A, corner B, corner C, then the central triangle.
        a, b, c = (
            np.concatenate([a, ab, ca, ab]),
            np.concatenate([ab, b, bc, bc]),
            np.concatenate([ca, bc, c, ca]),
        )
        nm, al = np.tile(nm, (4, 1)), np.tile(al, (4, 1))
        em, sm = np.tile(em, 4), np.tile(sm, 4)
    return triangles_from_arrays(np.stack([a, b, c], axis=1), nm, al, em, sm)
