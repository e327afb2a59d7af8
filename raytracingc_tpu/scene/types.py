"""Scene data model: structure-of-arrays JAX pytrees.

The reference keeps scenes as arrays-of-structs plus per-translation-unit C
globals (``scene.h:17-37``, ``raytracing.h:7-45``). Here the layout is
structure-of-arrays: one contiguous f32 array per attribute, padded to
a multiple of the accel block, registered as pytrees so they flow through
``jit``/``grad``/``shard_map`` and can themselves be optimization targets
(vertex positions, albedo, emission are all differentiable leaves).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from raytracingc_tpu.utils.pytree import pytree_node, static_field

# Matches the reference's intersection epsilon and miss sentinel
# (``scene.h:37``, ``raytracing.c:218``).
EPSILON = 1e-3
MISS_DST = 999999.0


@pytree_node
class Triangles:
    """Triangle soup, SoA.

    ``a/b/c``: vertex positions ``[T, 3]``; ``normal``: precomputed flat face
    normal ``[T, 3]`` (the reference backface-culls against this, not the
    geometric normal — ``raytracing.c:189``); ``albedo [T, 3]``,
    ``emission [T]``, ``smoothness [T]`` mirror the reference ``Material``
    (``raytracing.h:14-19``). Padding triangles are all-zero: a zero normal
    makes ``dot(dir, n) >= 0`` true, so they are culled exactly like the
    reference rejects backfaces.
    """

    a: jax.Array
    b: jax.Array
    c: jax.Array
    normal: jax.Array
    albedo: jax.Array
    emission: jax.Array
    smoothness: jax.Array

    @property
    def count(self) -> int:
        return self.a.shape[0]

    @classmethod
    def from_numpy(
        cls,
        verts: np.ndarray,  # [T, 3, 3] (A, B, C)
        normals: np.ndarray,  # [T, 3]
        albedo: np.ndarray,  # [T, 3]
        emission: np.ndarray,  # [T]
        smoothness: np.ndarray,  # [T]
    ) -> "Triangles":
        f32 = lambda x: jnp.asarray(np.asarray(x), dtype=jnp.float32)
        return cls(
            a=f32(verts[:, 0]),
            b=f32(verts[:, 1]),
            c=f32(verts[:, 2]),
            normal=f32(normals),
            albedo=f32(albedo),
            emission=f32(emission),
            smoothness=f32(smoothness),
        )

    @classmethod
    def empty(cls) -> "Triangles":
        z3 = jnp.zeros((0, 3), jnp.float32)
        z1 = jnp.zeros((0,), jnp.float32)
        return cls(a=z3, b=z3, c=z3, normal=z3, albedo=z3, emission=z1, smoothness=z1)


@pytree_node
class Spheres:
    """Sphere list, SoA (reference ``Sphere``, ``raytracing.h:21-26``).

    Padding spheres have ``radius <= 0`` and are treated as guaranteed misses.
    """

    center: jax.Array  # [S, 3]
    radius: jax.Array  # [S]
    albedo: jax.Array  # [S, 3]
    emission: jax.Array  # [S]
    smoothness: jax.Array  # [S]

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @classmethod
    def empty(cls) -> "Spheres":
        z3 = jnp.zeros((0, 3), jnp.float32)
        z1 = jnp.zeros((0,), jnp.float32)
        return cls(center=z3, radius=z1, albedo=z3, emission=z1, smoothness=z1)


@pytree_node
class EnvParams:
    """Procedural sky/sun environment (reference ``Scene``, ``raytracing.h:36-44``).

    Defaults mirror ``main.c:14-28`` (sun direction is stored normalized, as
    ``main.c:247-250`` does before rendering). The world is y-DOWN: the sky is
    at negative y (``raytracing.c:153-157``).
    """

    sun_direction: jax.Array  # [3], normalized
    sky_horizon: jax.Array  # [3]
    sky_zenith: jax.Array  # [3]
    ground: jax.Array  # [3]
    sun_focus: jax.Array  # scalar
    sun_intensity: jax.Array  # scalar

    @classmethod
    def default(cls) -> "EnvParams":
        sun = np.array([-30.0, -85.0, 100.0], np.float32)
        sun = sun / np.linalg.norm(sun)
        return cls(
            sun_direction=jnp.asarray(sun),
            sky_horizon=jnp.array([1.0, 1.0, 1.0], jnp.float32),
            sky_zenith=jnp.array([0.263, 0.969, 0.871], jnp.float32),
            ground=jnp.array([0.66, 0.66, 0.66], jnp.float32),
            sun_focus=jnp.float32(22.0),
            sun_intensity=jnp.float32(0.75),
        )


@pytree_node
class Scene:
    """Full scene: geometry + environment.

    ``n_triangles``/``n_spheres`` record the live (unpadded) counts as static
    metadata so kernels can mask padding without data-dependent shapes.

    ``accel`` optionally carries the Morton/block-AABB structure from
    ``ops.accel.build_accel`` (a permuted geometry copy + per-block bounds).
    The permuted resolve and geometry training read it; the search scans
    the original-order triangles either way. NOTE: when optimizing vertex
    positions, rebuild or drop the accel — its geometry copy does not
    receive gradient updates.
    """

    triangles: Triangles
    spheres: Spheres
    env: EnvParams
    accel: Any = None
    # Morton-permuted (T, 17) resolve table, attached IN-TRACE by
    # ``ops.intersect.with_perm_resolve`` at integrator entry: built from ``triangles`` via a differentiable
    # permutation gather, so the resolve's row-gather reads locality-sorted
    # rows (spatially-near winners → nearby rows) while values and
    # gradients stay exactly those of the original-order table. None =
    # resolve gathers the original-order SoA directly.
    resolve_perm: jax.Array | None = None
    n_triangles: int = static_field(default=0)
    n_spheres: int = static_field(default=0)
    # Block-sharded scenes (SURVEY §5.8 "block-sharded with all_gather",
    # ``parallel.sharded.render_sharded_blocks``): the mesh-axis name over
    # which this device's triangle buffers are a 1/n shard. When set, the
    # search lex-merges per-shard winners across the axis and the resolve
    # psum-combines the winner's payload; rays are replicated over the axis.
    # None (default) = every triangle buffer is whole on this device.
    shard_axis: str | None = static_field(default=None)

    @classmethod
    def build(
        cls,
        triangles: Triangles,
        spheres: Spheres,
        env: EnvParams | None = None,
        accel: Any = None,
    ) -> "Scene":
        return cls(
            triangles=triangles,
            spheres=spheres,
            env=env if env is not None else EnvParams.default(),
            accel=accel,
            n_triangles=triangles.count,
            n_spheres=spheres.count,
        )

    def with_accel(self) -> "Scene":
        """Return a copy carrying a freshly built block-AABB accel."""
        from raytracingc_tpu.ops.accel import build_accel

        return self.replace(
            accel=build_accel(self.triangles, self.n_triangles)
        )

    def with_triangles(
        self, triangles: Triangles, rebuild_accel: bool = False
    ) -> "Scene":
        """Replace triangle geometry, invalidating (or rebuilding) the accel.

        A bare ``scene.replace(triangles=...)`` silently leaves the accel's
        frozen geometry copy (block AABBs, permuted tables) stale. Route
        triangle updates through this helper: the accel is dropped or
        rebuilt on request.
        """
        out = self.replace(
            triangles=triangles, accel=None, n_triangles=triangles.count
        )
        return out.with_accel() if rebuild_accel else out

