"""chip_smoke.py off the card: it refuses to run, and each phase helper
works at a tiny size on the CPU (the kernel in the Pallas interpreter)."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from raytracingc_tpu.camera import Camera, primary_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "triton-interpret"


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_lone_script_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture(scope="module")
def rays():
    o, d = primary_rays(Camera.look_at(), 24, 16)
    so, sd = chip_smoke.secondary_rays(chip_smoke.box_scene(1), 256)
    return jnp.concatenate([o, so]), jnp.concatenate([d, sd])


def test_search_parity_phase(rays):
    p = chip_smoke.search_parity(chip_smoke.box_scene(1), *rays, KERNEL)
    assert p["mismatches"] == 0 and p["rays"] == 24 * 16 + 256
    assert p["hits"] > 300


def test_resolve_exactness_phase(rays):
    scene = chip_smoke.box_scene(0)
    assert chip_smoke.resolve_exactness(scene, *rays, KERNEL) == (
        2 * rays[0].shape[0] + scene.triangles.count + scene.spheres.count
    )


def test_production_frame_phase():
    r = chip_smoke.production_frame(
        chip_smoke.box_scene(0), KERNEL, width=16, height=12, spp=2,
        max_bounce=3,
    )
    assert r["rays"] > 0 and r["vs_xla"]["ok"]
    assert r["vs_xla"]["max_rel_diff"] <= chip_smoke.FRAME_TOL
    assert len(r["warm_s"][KERNEL]) == 2 and len(r["warm_s"]["xla"]) == 2


def test_cli_phase():
    img = chip_smoke.cli_render(16, 4, 4)
    assert img.shape == (16, 16, 3)


def test_fit_phase():
    r = chip_smoke.fit_check(chip_smoke.box_scene(0), 16, 2, 3, 1, KERNEL)
    assert np.isfinite(r["losses"]).all() and r["moved"] > 0
    assert r["grad_norm"] > 0 and r["grad_rel_diff"] <= chip_smoke.GRAD_RTOL


def test_sharded_phase():
    r = chip_smoke.sharded_check(
        chip_smoke.box_scene(1), 8, width=8, height=8, spp=8, max_bounce=3,
        train=dict(width=8, height=8, spp=2, max_bounce=2),
    )
    layouts = ("pixels/replicated", "samples/replicated", "pixels/blocks")
    assert set(r) == {*layouts, *(f"{k} s" for k in layouts),
                      "one chunk s", "chunked s", "chunked vs one chunk",
                      "train_loss_rel_diff"}
    for k in layouts:
        assert r[k]["rays"] == r[k]["ref_rays"] > 0
        assert r[k]["max_rel_diff"] <= chip_smoke.SHARD_TOL
    assert r["chunked vs one chunk"]["ok"]


def test_frame_agreement_counts_flips():
    ref = np.ones((1000, 1000, 3), np.float32)
    img = ref.copy()
    img[0, 0] = 2.0  # one flipped pixel
    r = chip_smoke.frame_agreement(img, 1000.0, ref, 1000.0)
    assert r["pixels_over"] == 1 and r["ok"]
    img[:2] = 2.0  # 2,000 pixels: past PIXEL_FRACTION of 10^6
    assert not chip_smoke.frame_agreement(img, 1000.0, ref, 1000.0)["ok"]
    assert not chip_smoke.frame_agreement(ref, 1001.0, ref, 1000.0)["ok"]
