"""Device-mesh construction and multi-host bring-up.

The reference's only "backend" is pthread fork/join in one address space
(``main.c:285-302``). The replacement here is a named device mesh:

* ``px`` — the image/pixel axis (the analog of the reference's row-cyclic
  thread decomposition, ``main.c:84``). Sharding rays over ``px`` needs no
  communication during tracing; only the final image assembly (and, when
  training, gradient ``pmean``) crosses devices.
* ``spp`` — the sample axis (the analog of the 4000-iteration accumulation
  loop, ``main.c:98-99``): each device traces a disjoint slice of sample ids
  and the per-device means are ``pmean``-combined.

Multi-host clusters call :func:`initialize_distributed` once per process
before any jax usage; afterwards ``jax.devices()`` spans every process's
devices and the same mesh code works unchanged.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize``.

    Pass the coordinator's ``host:port``, the process count and this
    process's id; JAX discovers them itself only on clusters whose runtime
    publishes them. A no-op when ``num_processes <= 1``.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    px: int | None = None,
    spp: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a ``(px, spp)`` mesh over the available devices.

    ``px=None`` takes every device not consumed by ``spp``. The defaults give
    a 1-D pixel mesh over all devices — the pure image-space decomposition.
    The device list is reshaped in order: every device reaches every other
    at the same rate over NVLink, so the layout follows the algorithm only.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if px is None:
        assert n % spp == 0, f"{n} devices not divisible by spp={spp}"
        px = n // spp
    assert px * spp <= n, f"mesh {px}x{spp} exceeds {n} devices"
    grid = np.asarray(devices[: px * spp]).reshape(px, spp)
    return Mesh(grid, axis_names=("px", "spp"))
