"""Camera: look-at basis and primary-ray generation.

Reference semantics (``main.c:84-94, 252-255``):

* World is y-DOWN. The basis is ``ez = normalize(look_at - origin)``,
  ``up = (0, -1, 0)``, ``ex = normalize(cross(ez, up))``,
  ``ey = normalize(cross(ez, ex))``.
* Per pixel (x right, y down, row-major, y=0 is the TOP row):
  ``dx = (x - W//2) / (H//2)``, ``dy = (y - H//2) / (H//2)`` — note the C
  INTEGER divisions ``width / 2`` and ``height / 2``, reproduced here — then
  ``dir = normalize(dx*ex + dy*ey + fov*ez)``. ``fov`` is a focal-length
  scalar: larger = narrower field of view (default 1.0).

Defaults: origin ``(-4.75, -1.5, -4.75)``, look-at ``(0.9, -1.2, 1)``
(``main.c:114-116``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingc_tpu.utils.pytree import pytree_node

DEFAULT_ORIGIN = (-4.75, -1.5, -4.75)
DEFAULT_LOOK_AT = (0.9, -1.2, 1.0)


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@pytree_node
class Camera:
    """Camera pose as a pytree: differentiable origin/basis, static fov scalar."""

    origin: jax.Array  # [3]
    ex: jax.Array  # [3]
    ey: jax.Array  # [3]
    ez: jax.Array  # [3]
    fov: jax.Array  # scalar (focal length)

    @classmethod
    def look_at(
        cls,
        origin=DEFAULT_ORIGIN,
        target=DEFAULT_LOOK_AT,
        fov: float = 1.0,
    ) -> "Camera":
        origin = jnp.asarray(origin, jnp.float32)
        target = jnp.asarray(target, jnp.float32)
        ex, ey, ez = look_at_basis(origin, target)
        return cls(origin=origin, ex=ex, ey=ey, ez=ez, fov=jnp.float32(fov))


def look_at_basis(origin: jax.Array, target: jax.Array):
    """y-down look-at basis (``main.c:252-255``). Returns (ex, ey, ez)."""
    ez = _normalize(target - origin)
    up = jnp.array([0.0, -1.0, 0.0], jnp.float32)
    ex = _normalize(jnp.cross(ez, up))
    ey = _normalize(jnp.cross(ez, ex))
    return ex, ey, ez


def primary_rays(camera: Camera, width: int, height: int):
    """Generate primary ray origins/directions for every pixel.

    Returns ``(origins [H*W, 3], dirs [H*W, 3])`` in row-major order with y=0
    at the top, matching the reference's image indexing
    (``image[x + y*width]``, ``main.c:100``).
    """
    half_w = width // 2  # C integer division, ``main.c:88``
    # The C code divides by height/2 unguarded (``main.c:88-89``) — a
    # 1-pixel-high image divides by zero there; we clamp to 1 instead.
    half_h = max(height // 2, 1)
    xs = (jnp.arange(width, dtype=jnp.float32) - half_w) / half_h
    ys = (jnp.arange(height, dtype=jnp.float32) - half_h) / half_h
    dx = jnp.tile(xs, height)  # [H*W], row-major
    dy = jnp.repeat(ys, width)
    dirs = (
        dx[:, None] * camera.ex[None, :]
        + dy[:, None] * camera.ey[None, :]
        + camera.fov * camera.ez[None, :]
    )
    dirs = _normalize(dirs)
    origins = jnp.broadcast_to(camera.origin, dirs.shape)
    return origins, dirs
