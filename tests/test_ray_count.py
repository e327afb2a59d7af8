"""Exact traced-ray counts (``render.integrator.RayCount``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from raytracingc_tpu.parallel.mesh import make_mesh
from raytracingc_tpu.parallel.sharded import shard_map
from raytracingc_tpu.render.integrator import RayCount


def _int(c: RayCount) -> int:
    return int(c.hi) * (1 << 16) + int(c.lo)


def test_exact_past_float32_integers():
    """A float32 running sum stops counting at 2**24; the count does not."""
    parts = [2**24 - 1, 1, 1, 1]
    c = RayCount.zero()
    f = jnp.float32(0)
    for n in parts:
        c = c + RayCount.of(jnp.int32(n))
        f = f + jnp.float32(n)
    assert _int(c) == sum(parts)
    assert float(f) != sum(parts)
    assert float(c) == float(np.float32(sum(parts)))


def test_order_independent():
    rng = np.random.default_rng(0)
    parts = rng.integers(0, 2**31 - 1, size=64)
    fwd, rev = RayCount.zero(), RayCount.zero()
    for n in parts:
        fwd = fwd + RayCount.of(jnp.int32(n))
    for n in parts[::-1]:
        rev = rev + RayCount.of(jnp.int32(n))
    assert _int(fwd) == _int(rev) == int(parts.sum())
    assert int(fwd.lo) < 2**16


@pytest.mark.parametrize("k", [0, 1, 7, 4000, 2**16 + 3])
def test_times_static_factor(k):
    n = 2**31 - 5
    assert _int(RayCount.of(jnp.int32(n)).times(k)) == n * k


def test_sum_over_chunks_under_jit():
    counts = jnp.array([2**30, 2**30, 2**30, 12345, 0], jnp.int32)
    total = jax.jit(lambda x: jax.vmap(RayCount.of)(x).sum())(counts)
    assert _int(total) == int(np.asarray(counts, np.int64).sum())


def test_psum_over_mesh():
    mesh = make_mesh(px=len(jax.devices()), spp=1)
    n = mesh.shape["px"]
    per = jnp.full((n,), 2**30 + 7, jnp.int32)

    def body(x):
        c = RayCount.of(x[0]).psum("px")
        return c.hi[None], c.lo[None]

    hi, lo = shard_map(body, mesh=mesh, in_specs=P("px"),
                       out_specs=(P("px"), P("px")), check_vma=False)(per)
    assert int(hi[0]) * 2**16 + int(lo[0]) == n * (2**30 + 7)
