"""Locality-sorted resolve tables: the Morton-permuted resolve gathers the
same bits as the original-order table."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracingc_tpu.camera import Camera, primary_rays
from raytracingc_tpu.ops.intersect import (
    PERM_RESOLVE_MIN_T,
    with_perm_resolve,
)
from raytracingc_tpu.render.integrator import trace_accumulate
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.scene.builder import scene_from_triangles_txt, tessellate
from raytracingc_tpu.scene.types import Scene


@pytest.fixture(scope="module")
def scene(box_scene_path):
    """The in-repo room tessellated to 640 triangles (past the one-hot
    resolve's 256 rows, so the permuted table can attach)."""
    base = scene_from_triangles_txt(box_scene_path)
    tris, n = tessellate(base.triangles, base.n_triangles, levels=3)
    return Scene.build(tris, base.spheres, base.env).replace(
        n_triangles=n, n_spheres=base.n_spheres
    ).with_accel()


def test_perm_resolve_render_bitwise(scene, monkeypatch):
    """The Morton-permuted resolve table is a permutation gather of the
    original rows: renders must be BITWISE equal and trace identical ray
    counts whichever table the resolve reads."""
    cam = Camera.look_at()
    outs = {}
    for mode in ("orig", "perm"):
        monkeypatch.setenv("RTC_RESOLVE", mode)
        img, count = render(scene, cam, 32, 32, spp=2, max_bounce=4, seed=3)
        outs[mode] = (np.asarray(img), float(count))
    assert outs["orig"][1] == outs["perm"][1]
    np.testing.assert_array_equal(outs["orig"][0], outs["perm"][0])


def test_perm_resolve_gradients_match(scene, monkeypatch):
    """Material/vertex gradients must flow unchanged through the permuted
    table (it is built in-trace from scene.triangles; the permutation is a
    bijection, so even the transpose scatter has unique indices)."""
    cam = Camera.look_at()
    o, d = primary_rays(cam, 16, 16)
    ids = jnp.arange(16 * 16, dtype=jnp.uint32)

    def loss(tris_param, mode, monkeypatch=monkeypatch):
        monkeypatch.setenv("RTC_RESOLVE", mode)
        s = scene.replace(triangles=tris_param)  # same (stale-free) accel
        radiance, _ = trace_accumulate(
            o, d, s, ids, seed=0, spp=1, max_bounce=3
        )
        return jnp.sum(radiance**2)

    grads = {}
    for mode in ("orig", "perm"):
        g = jax.grad(lambda tp: loss(tp, mode))(scene.triangles)
        grads[mode] = (np.asarray(g.albedo), np.asarray(g.a))
    np.testing.assert_array_equal(grads["orig"][0], grads["perm"][0])
    np.testing.assert_array_equal(grads["orig"][1], grads["perm"][1])
    assert np.abs(grads["orig"][0]).max() > 0  # not vacuously zero


def test_perm_resolve_auto_threshold(scene, monkeypatch):
    """auto = permuted table only at streamed scale (the measured
    crossover); forcing perm attaches it on any accel scene."""
    monkeypatch.delenv("RTC_RESOLVE", raising=False)
    assert scene.triangles.count < PERM_RESOLVE_MIN_T
    assert with_perm_resolve(scene).resolve_perm is None  # auto: small scene
    monkeypatch.setenv("RTC_RESOLVE", "perm")
    sc2 = with_perm_resolve(scene)
    assert sc2.resolve_perm is not None
    assert sc2.resolve_perm.shape == (scene.triangles.count, 17)
    monkeypatch.setenv("RTC_RESOLVE", "nope")
    with pytest.raises(AssertionError):
        with_perm_resolve(scene)


def test_perm_of_orig_inverts_orig_idx(scene):
    """The permuted resolve's slot map really inverts the accel's order:
    orig_idx[perm_of_orig[i]] == i for live triangles."""
    accel = scene.accel
    assert accel is not None and accel.perm_of_orig is not None
    n = scene.n_triangles
    oi = np.asarray(accel.orig_idx)
    po = np.asarray(accel.perm_of_orig)
    np.testing.assert_array_equal(oi[po[:n]], np.arange(n))
