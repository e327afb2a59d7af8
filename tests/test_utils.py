"""Checkpoint, profiling, and progressive-render tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingc_tpu.camera import Camera
from raytracingc_tpu.render.progressive import render_progressive
from raytracingc_tpu.render.renderer import render
from raytracingc_tpu.utils.checkpoint import load_pytree, save_pytree
from raytracingc_tpu.utils.profiling import Profiler


@pytest.fixture(scope="module")
def demo_scene():
    from __graft_entry__ import _demo_scene

    return _demo_scene()


@pytest.fixture(scope="module")
def cam():
    return Camera.look_at()


def test_checkpoint_roundtrip(tmp_path, demo_scene):
    path = str(tmp_path / "scene.npz")
    save_pytree(path, demo_scene, step=42)
    restored, step = load_pytree(path, demo_scene)
    assert step == 42
    np.testing.assert_array_equal(
        np.asarray(restored.triangles.a), np.asarray(demo_scene.triangles.a)
    )
    assert restored.triangles.a.dtype == jnp.float32


def test_progressive_matches_oneshot(demo_scene, cam):
    """Batched accumulation with disjoint sample ids must equal the one-shot
    render with the same total spp exactly (counter-based RNG)."""
    w = h = 8
    ref, count_ref = render(demo_scene, cam, w, h, spp=4, max_bounce=2, seed=9)
    img, count = render_progressive(
        demo_scene, cam, w, h, spp=4, max_bounce=2, batch_spp=2, seed=9
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), rtol=2e-6, atol=2e-7)
    assert float(count) == float(count_ref)


def test_progressive_resume(demo_scene, cam, tmp_path):
    w = h = 8
    ck = str(tmp_path / "render.npz")
    ref, _ = render_progressive(
        demo_scene, cam, w, h, spp=4, max_bounce=2, batch_spp=2, seed=9
    )
    # Simulate preemption: run only the first batch, then resume to completion.
    calls = []

    def abort_after_first(done, total, _img):
        calls.append(done)
        if done >= 2 and total > done:
            raise KeyboardInterrupt

    try:
        render_progressive(
            demo_scene, cam, w, h, spp=4, max_bounce=2, batch_spp=2, seed=9,
            checkpoint_path=ck, on_batch=abort_after_first,
        )
    except KeyboardInterrupt:
        pass
    img, _ = render_progressive(
        demo_scene, cam, w, h, spp=4, max_bounce=2, batch_spp=2, seed=9,
        checkpoint_path=ck,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), rtol=2e-6, atol=2e-7)


def test_early_exit_matches_scan(demo_scene, cam):
    """Early exit (hit-front accumulation) == fixed-length scan up to float
    re-association of the bounce-0 light sum; ray counts exactly equal."""
    w = h = 8
    a, ca = render(demo_scene, cam, w, h, spp=2, max_bounce=4, seed=1,
                   early_exit=False, compact=False)
    b, cb = render(demo_scene, cam, w, h, spp=2, max_bounce=4, seed=1,
                   early_exit=True)
    assert float(ca) == float(cb)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=3e-6, atol=3e-7)


def test_profiler():
    prof = Profiler()
    with prof.phase("x"):
        pass
    prof.add_rays(100)
    s = prof.summary()
    assert "x=" in s and "rays/s=" in s


def test_render_resilient_retries_and_resumes():
    from raytracingc_tpu.utils.resilient import RenderFailure, render_resilient

    state = {"progress": 0, "fails": 2}

    def batches():
        state["progress"] += 1
        if state["fails"] > 0:
            state["fails"] -= 1
            raise RuntimeError("transient device loss")
        return ("done", state["progress"])

    out = render_resilient(
        batches, progress=lambda: state["progress"], max_retries=2,
        backoff_s=0.0,
    )
    assert out[0] == "done"

    # No progress + deterministic failure → RenderFailure after retries.
    def always_fails():
        raise RuntimeError("boom")

    import pytest as _pytest

    with _pytest.raises(RenderFailure):
        render_resilient(always_fails, progress=lambda: 0, max_retries=1,
                         backoff_s=0.0)


def test_cli_checkpoint_flag(tmp_path, box_scene_path):
    import os

    from raytracingc_tpu.cli import main

    out = str(tmp_path / "o.bmp")
    ck = str(tmp_path / "ck.npz")
    rc = main(["--triangles", box_scene_path, "-s", "8", "8",
               "--spp", "4", "-b", "2", "--batch-spp", "2",
               "--checkpoint", ck, "-o", out])
    assert rc == 0 and os.path.exists(ck) and os.path.exists(out)


def test_profiler_trace_capture(tmp_path, demo_scene, cam):
    """jax.profiler trace wrappers produce a trace directory without error."""
    from raytracingc_tpu.utils.profiling import start_trace, stop_trace

    start_trace(str(tmp_path))
    img, _ = render(demo_scene, cam, 4, 4, spp=1, max_bounce=1, seed=0)
    np.asarray(img)
    stop_trace()
    import os

    assert any(os.scandir(str(tmp_path))), "no trace output written"
