"""Regression tests for the round-2 ADVICE findings fixed in round 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.diff.optimize import is_geometry_trained
from raytracingc_tpu.render.progressive import render_progressive


def test_geometry_trained_classification():
    """ADVICE r2: "triangles.a" is a substring-prefix of "triangles.albedo";
    the old bidirectional match classified material-only training as geometry
    training and silently forfeited accel reuse."""
    assert is_geometry_trained(None)  # everything trainable
    assert is_geometry_trained(["triangles.a"])
    assert is_geometry_trained(["triangles.normal"])
    assert is_geometry_trained(["triangles"])  # matches all triangle leaves
    # Material-only paths must NOT classify as geometry:
    assert not is_geometry_trained(["triangles.albedo"])
    assert not is_geometry_trained(["albedo"])
    assert not is_geometry_trained(["triangles.emission", "env"])
    assert not is_geometry_trained(["spheres.center"])


def _tiny_scene():
    from __graft_entry__ import _demo_scene

    return _demo_scene()


def test_progressive_samples_shard_validates_batches_up_front():
    """ADVICE r2 (medium): spp=100/batch_spp=64 over an 8-way samples mesh
    used to crash on the FINAL batch (36 % 8 != 0) after most of the render
    completed. Must now raise a clear ValueError before rendering starts."""
    scene = _tiny_scene()
    cam = Camera.look_at()
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs a multi-device mesh")
    with pytest.raises(ValueError, match="divisible"):
        render_progressive(
            scene, cam, 8, 8, spp=12 * n + n // 2, max_bounce=1,
            batch_spp=8 * n, shard_strategy="samples",
        )
    # batch_spp itself non-divisible must also raise even when
    # spp % batch_spp == 0 (two equal bad batches).
    if n >= 4:
        with pytest.raises(ValueError, match="divisible"):
            render_progressive(
                scene, cam, 8, 8, spp=2 * (n - 1), max_bounce=1,
                batch_spp=n - 1, shard_strategy="samples",
            )
    # A divisible split renders fine and matches the pixels-sharded result.
    img, _ = render_progressive(
        scene, cam, 8, 8, spp=2 * n, max_bounce=1, batch_spp=n,
        shard_strategy="samples",
    )
    assert np.all(np.isfinite(np.asarray(img)))
