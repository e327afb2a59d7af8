"""Multi-chip / multi-host execution: meshes, sharded render, sharded training.

The reference scales with 12 pthreads over image rows on one shared-memory
node (``main.c:81-105,284-303``). Here the same decomposition is a
``jax.sharding.Mesh`` over the devices: the pixel axis sharded per device
(the row-cyclic analog), the sample axis optionally sharded as a second mesh
dimension, scene buffers replicated or block-sharded, and radiance /
scene-parameter gradients combined with ``psum``/``pmean``.
"""

from raytracingc_tpu.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from raytracingc_tpu.parallel.sharded import (  # noqa: F401
    make_train_step,
    render_sharded,
)
