"""CLI end-to-end tests (CPU, tiny renders) — the reference C16 flag surface."""

import os

import numpy as np
import pytest

from raytracingc_tpu.cli import build_parser, main
from raytracingc_tpu.render.image import read_bmp


def test_reference_flags_parse():
    """Every reference flag spelling parses (``main.c:119-231``)."""
    p = build_parser()
    a = p.parse_args([
        "-i", "x.obj", "-o", "y.bmp", "-p", "1", "2", "3", "-t", "0", "0", "0",
        "-f", "2.0", "-s", "64", "32", "-b", "5",
        "-gc", ".1", ".2", ".3", "-sch", "1", "1", "1", "-scz", "0", "1", "1",
        "--sun", "1", "2", "3", "10", "0.5",
    ])
    assert a.input == "x.obj" and a.size == [64, 32] and a.max_bounce == 5
    assert a.sun == [1.0, 2.0, 3.0, 10.0, 0.5]


def test_unknown_flag_errors():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--definitely-not-a-flag"])


def test_cli_obj_render(models_dir, tmp_path, capsys):
    out = str(tmp_path / "out.bmp")
    rc = main(["-i", os.path.join(models_dir, "simplest.obj"),
               "-s", "8", "8", "--spp", "2", "-b", "2", "-o", out])
    assert rc == 0
    img = read_bmp(out)
    assert img.shape == (8, 8, 3)
    assert capsys.readouterr().out.count("rays traced") == 1


def test_cli_default_mode(box_scene_path, tmp_path):
    out = str(tmp_path / "out.png")
    rc = main(["--triangles", box_scene_path,
               "-s", "8", "8", "--spp", "2", "-b", "2", "-o", out])
    assert rc == 0


def test_cli_debug_bounces(models_dir, tmp_path):
    out = str(tmp_path / "dbg.bmp")
    rc = main(["-i", os.path.join(models_dir, "cube.obj"),
               "-s", "8", "8", "-b", "4", "--debug-bounces", "-o", out])
    assert rc == 0
    img = read_bmp(out)
    # Grayscale heatmap: channels equal; some rays hit (nonzero pixels).
    assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()
    assert img.max() > 0


def test_cli_sharded(models_dir, tmp_path):
    out = str(tmp_path / "sh.bmp")
    rc = main(["-i", os.path.join(models_dir, "simplest.obj"),
               "-s", "8", "8", "--spp", "2", "-b", "2",
               "--shard", "pixels", "-o", out])
    assert rc == 0
    assert read_bmp(out).shape == (8, 8, 3)


def test_objtest_cli(models_dir, capsys):
    from raytracingc_tpu.objtest import main as objtest_main

    rc = objtest_main([os.path.join(models_dir, "ultracomplex.obj")])
    assert rc == 0
    assert "120 triangles" in capsys.readouterr().out
    assert objtest_main(["/nonexistent.obj"]) == 1


def test_cli_tessellate(models_dir, tmp_path):
    """--tessellate N subdivides 4^N-fold and renders the SAME image (the
    children tile the parents; one-command driver for the tile-streamed
    kernel at scale). The guarantee is float-level, not bitwise — child MT
    distances can differ in ulps, which may cross a tonemap quantization
    boundary — so allow a ±1 uint8 step on a small minority of pixels."""
    out0 = str(tmp_path / "plain.bmp")
    out2 = str(tmp_path / "tess.bmp")
    base = ["-i", os.path.join(models_dir, "simplest.obj"),
            "-s", "8", "8", "--spp", "2", "-b", "2"]
    assert main(base + ["-o", out0]) == 0
    assert main(base + ["--tessellate", "2", "-o", out2]) == 0
    a = read_bmp(out0).astype(int)
    b = read_bmp(out2).astype(int)
    diff = np.abs(a - b)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.95, (diff != 0).sum()


def test_cli_profile_smoke(models_dir, tmp_path, capsys):
    """--profile prints the phase timing breakdown without disturbing the
    render (smoke: the subsystem SURVEY §5.1 promises)."""
    out = str(tmp_path / "p.bmp")
    rc = main(["-i", os.path.join(models_dir, "simplest.obj"),
               "-s", "8", "8", "--spp", "2", "-b", "2", "--profile",
               "-o", out])
    assert rc == 0
    text = capsys.readouterr().out
    assert "rays traced" in text
    assert read_bmp(out).shape == (8, 8, 3)


def test_read_image_dispatch(tmp_path):
    """read_image routes on extension like write_image (BMP and PNG)."""
    from raytracingc_tpu.render.image import read_image, write_image

    img = (np.arange(4 * 4 * 3).reshape(4, 4, 3) * 17 % 256).astype(np.uint8)
    for ext in ("bmp", "png"):
        path = str(tmp_path / f"d.{ext}")
        write_image(path, img)
        np.testing.assert_array_equal(read_image(path), img)
