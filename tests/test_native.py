"""Native C++ loader: build, parity with Python parsers, error paths."""

import os

import numpy as np
import pytest

from raytracingc_tpu.scene import native
from raytracingc_tpu.scene.obj_loader import load_obj
from raytracingc_tpu.scene.triangles_txt import load_triangles_txt

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native loader not built (no g++?)"
)


@pytest.mark.parametrize(
    "name", ["simplest.obj", "cube.obj", "suzannes.obj", "ultracomplex.obj"]
)
def test_obj_parity(models_dir, name):
    path = os.path.join(models_dir, name)
    v, n, a, e, s = native.load_obj_native(path)
    mesh = load_obj(path)
    np.testing.assert_allclose(v, mesh.verts, rtol=0, atol=0)
    np.testing.assert_allclose(n, mesh.normals, rtol=0, atol=0)
    np.testing.assert_allclose(a, mesh.albedo, rtol=0, atol=0)
    np.testing.assert_allclose(e, mesh.emission, rtol=0, atol=0)
    np.testing.assert_allclose(s, mesh.smoothness, rtol=0, atol=0)


def test_missing_mtl_warns_not_errors(models_dir):
    """simple.obj references a missing test.mtl — default materials result."""
    v, n, a, e, s = native.load_obj_native(os.path.join(models_dir, "simple.obj"))
    assert (a == 1.0).all() and (e == 0.0).all()


def test_triangles_txt_parity(box_scene_path):
    path = box_scene_path
    got = native.load_triangles_txt_native(path)
    ref = load_triangles_txt(path)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-7)


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        native.load_obj_native("/nonexistent/x.obj")


def test_v_slash_slash_n_rejected(tmp_path):
    """The reference exit(69)s on 'f v//vn' faces; we raise ValueError."""
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    with pytest.raises(ValueError, match="69"):
        native.load_obj_native(str(p))


def test_builder_native_matches_python(models_dir):
    from raytracingc_tpu.scene.builder import scene_from_obj

    path = os.path.join(models_dir, "asuzane.obj")
    sn = scene_from_obj(path, use_native=True)
    sp = scene_from_obj(path, use_native=False)
    np.testing.assert_array_equal(
        np.asarray(sn.triangles.a), np.asarray(sp.triangles.a)
    )
    np.testing.assert_array_equal(
        np.asarray(sn.triangles.albedo), np.asarray(sp.triangles.albedo)
    )
    assert sn.n_triangles == sp.n_triangles


def test_stale_library_is_detected(tmp_path):
    """A library older than rtc_loader.cpp (e.g. copied along with a working
    tree) is stale and gets rebuilt instead of loaded."""
    src, lib = tmp_path / "rtc_loader.cpp", tmp_path / "librtc_loader.so"
    src.write_text("// source")
    assert native.is_stale(str(lib), str(src))  # missing library
    lib.write_text("binary")
    os.utime(src, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not native.is_stale(str(lib), str(src))
    os.utime(src, (3000, 3000))
    assert native.is_stale(str(lib), str(src))


def test_stale_library_rebuild_from_source(tmp_path, monkeypatch):
    """build() runs make only when the library is stale."""
    calls = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd))
    monkeypatch.setattr(native, "is_stale", lambda *a: False)
    assert native.build()
    assert calls == []
    monkeypatch.setattr(native, "is_stale", lambda *a: True)
    native.build()
    assert calls and calls[0][:2] == ["make", "-B"]
