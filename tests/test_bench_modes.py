"""bench.py prints ONE JSON line per run: pin the schema of all three modes
— render, BENCH_MODE=train, BENCH_SHARD — on tiny CPU configs (explicit
``JAX_PLATFORMS=cpu``, the only way bench.py runs off the GPU)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")


def _run_bench(extra_env, timeout=900, platforms="cpu"):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platforms
    # Force exactly 2 virtual devices (the test-process conftest exports 8;
    # the shard test's spp=2 must divide the mesh's sample dimension).
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.update(extra_env)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )
    if extra_env.get("_expect_failure"):
        return out
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1, out.stdout  # ONE JSON line
    return json.loads(lines[0])


def test_bench_render_mode_schema():
    j = _run_bench({"BENCH_W": "32", "BENCH_H": "32", "BENCH_SPP": "1",
                    "BENCH_BOUNCE": "2", "BENCH_REPEATS": "1"})
    for key in ("metric", "value", "unit", "repeats",
                "compile_s", "backend", "mesh", "sample_group",
                "blocked_rays_s", "stream_frames", "platform",
                "device_kind", "device_count"):
        assert key in j, key
    assert j["unit"] == "rays/s" and j["value"] > 0
    assert j["mesh"] is None
    assert j["platform"] == "cpu" and j["device_kind"] in j["metric"]
    assert "box_scene.txt ×256 (2560 tris)" in j["metric"]
    assert "vs_baseline" not in j  # the C anchors are on another scene
    # value is whichever methodology won; the label must agree (round-4
    # review finding: never claim steady-state for a blocked number).
    assert j["value"] >= j["blocked_rays_s"]
    if j["stream_frames"] > 1:
        assert "steady-state" in j["metric"]
    else:
        assert "steady-state" not in j["metric"]


def test_bench_stream_disabled_schema():
    j = _run_bench({"BENCH_W": "32", "BENCH_H": "32", "BENCH_SPP": "1",
                    "BENCH_BOUNCE": "2", "BENCH_REPEATS": "1",
                    "BENCH_STREAM": "1"})
    assert j["stream_frames"] == 1
    assert "steady-state" not in j["metric"]
    assert j["value"] == j["blocked_rays_s"]


def test_bench_shard_mode_schema():
    j = _run_bench({"BENCH_W": "32", "BENCH_H": "32", "BENCH_SPP": "2",
                    "BENCH_BOUNCE": "2", "BENCH_REPEATS": "1",
                    "BENCH_SHARD": "samples"})
    assert j["mesh"] == {"px": 1, "spp": 2}
    assert "shard=samples" in j["metric"]
    assert j["value"] > 0


_TRAIN_SMALL = {"BENCH_MODE": "train", "BENCH_REPEATS": "1",
                "BENCH_W": "16", "BENCH_H": "16", "BENCH_SPP": "1",
                "BENCH_BOUNCE": "2", "BENCH_TESS": "1"}


def test_bench_train_mode_schema():
    j = _run_bench(_TRAIN_SMALL)
    for key in ("geom_step_s", "material_step_s", "material_rays_s",
                "forward_scan_s", "forward_scan_rays_s", "geom_over_forward",
                "material_over_forward", "geom_loss_accel"):
        assert key in j, key
    assert j["value"] > 0 and j["geom_over_forward"] > 0
    assert "train-step" in j["metric"]
    # The tessellated room carries a real accel → the geometry loss
    # refreshes it in-trace; BENCH_TRAIN_ACCELFREE=1 reverts for the A/B.
    assert j["geom_loss_accel"] == "refresh"
    j2 = _run_bench(dict(_TRAIN_SMALL, BENCH_TRAIN_ACCELFREE="1"))
    assert j2["geom_loss_accel"] == "none"


def test_bench_tessellation_knob():
    """BENCH_TESS=k scales the scene 4**k-fold before benching."""
    j = _run_bench({"BENCH_MODE": "train", "BENCH_REPEATS": "1",
                    "BENCH_TESS": "2", "BENCH_W": "16", "BENCH_H": "16",
                    "BENCH_SPP": "1", "BENCH_BOUNCE": "2"})
    assert "box_scene.txt ×16 (160 tris)" in j["metric"]
    assert j["geom_loss_accel"] == "refresh" and j["value"] > 0


def test_bench_named_scene_is_not_tessellated():
    """Only the default scene is tessellated by default; the label gives a
    named scene's triangle count."""
    j = _run_bench({"BENCH_MODE": "train", "BENCH_REPEATS": "1",
                    "BENCH_SCENE": os.path.join("examples", "box_scene.txt"),
                    "BENCH_W": "16", "BENCH_H": "16", "BENCH_SPP": "1",
                    "BENCH_BOUNCE": "2"})
    assert "box_scene.txt (10 tris)" in j["metric"]
    assert "×" not in j["metric"]


def test_bench_refuses_cpu_unless_asked():
    """Without an explicit JAX_PLATFORMS=cpu, bench.py on a machine with no
    GPU exits with an error and prints no result."""
    out = _run_bench({"_expect_failure": "1", "BENCH_W": "8", "BENCH_H": "8"},
                     platforms="")
    assert out.returncode != 0
    assert "measures the GPU" in out.stderr
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


def test_bench_missing_scene_fails():
    out = _run_bench({"_expect_failure": "1",
                      "BENCH_SCENE": "/nonexistent/scene.obj"})
    assert out.returncode != 0 and "does not exist" in out.stderr
