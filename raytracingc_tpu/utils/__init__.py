"""Cross-cutting utilities: checkpointing, profiling, observability.

The reference has none of these (SURVEY.md §5: no timers, no checkpoints, a
``.parsed`` disk cache as the only persisted intermediate). They are
first-class here because multi-device renders and optimization runs are
long-lived jobs.
"""

from raytracingc_tpu.utils.checkpoint import (  # noqa: F401
    load_pytree,
    save_pytree,
)
from raytracingc_tpu.utils.profiling import Profiler, trace_annotation  # noqa: F401
from raytracingc_tpu.utils.resilient import (  # noqa: F401
    RenderFailure,
    render_resilient,
)
