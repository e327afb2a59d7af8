"""The frozen-dataclass pytrees behind Scene, Camera, the accel and hits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.ops.intersect import HitRef
from raytracingc_tpu.scene.builder import scene_from_triangles_txt
from raytracingc_tpu.scene.types import Scene
from raytracingc_tpu.utils.pytree import pytree_node, static_field


@pytest.fixture(scope="module")
def scene(box_scene_path):
    return scene_from_triangles_txt(box_scene_path)


def test_replace_returns_a_new_node(scene):
    moved = scene.replace(n_triangles=3)
    assert moved.n_triangles == 3 and scene.n_triangles == 10
    assert moved.triangles is scene.triangles
    with pytest.raises(dataclasses.FrozenInstanceError):
        scene.n_triangles = 4


def test_meta_fields_live_in_the_treedef(scene):
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    assert all(hasattr(x, "shape") for x in leaves)  # no ints, no strings
    other = jax.tree_util.tree_structure(scene.replace(shard_axis="px"))
    assert other != treedef  # static fields are part of the structure
    assert jax.tree_util.tree_structure(scene.replace(accel=None)) != treedef


def test_flatten_round_trip(scene):
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, Scene)
    assert (back.n_triangles, back.n_spheres, back.shard_axis) == (
        scene.n_triangles, scene.n_spheres, scene.shard_axis
    )
    np.testing.assert_array_equal(np.asarray(back.triangles.a),
                                  np.asarray(scene.triangles.a))
    assert isinstance(back.accel, type(scene.accel))


def test_keystr_paths_name_the_fields(scene):
    """Block sharding and leaf filters match leaves by these paths."""
    paths = {jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(scene)[0]}
    assert {".triangles.a", ".spheres.radius", ".env.sun_focus",
            ".accel.orig_idx"} <= paths


def test_static_fields_are_static_under_jit(scene):
    traces = []

    @jax.jit
    def f(s):
        traces.append(s.n_triangles)  # a Python int, not a tracer
        return jnp.sum(s.triangles.a) * s.n_triangles

    f(scene)
    f(scene.replace(triangles=scene.triangles.replace(a=scene.triangles.a + 1)))
    assert traces == [10]  # new leaves, same structure: no retrace
    f(scene.replace(n_triangles=9))
    assert traces == [10, 9]  # new static value: retrace


def test_grad_reaches_data_fields_only():
    cam = Camera.look_at()
    g = jax.grad(lambda c: jnp.sum(c.origin * c.fov))(cam)
    assert isinstance(g, Camera)
    np.testing.assert_allclose(np.asarray(g.origin), 1.0)


def test_pytree_node_decorator():
    @pytree_node
    class Pair:
        x: jax.Array
        tag: str = static_field(default="a")

    p = Pair(x=jnp.ones(2))
    q = jax.tree_util.tree_map(lambda v: v * 2, p)
    assert q.tag == "a" and np.asarray(q.x).tolist() == [2.0, 2.0]
    assert p.replace(tag="b").tag == "b"
    h = HitRef(hit=jnp.zeros(1, bool), is_tri=jnp.zeros(1, bool),
               idx=jnp.zeros(1, jnp.int32))
    assert len(jax.tree_util.tree_leaves(h)) == 3
