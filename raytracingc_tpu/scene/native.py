"""ctypes bindings for the native C++ scene loader.

The compute path is JAX (XLA and one Pallas kernel); the ingest runtime around it is native
C++ (``native/rtc_loader.cpp``), mirroring the reference's C loader layer
(``objloader.c``, ``raytracing.c:19-98``) — built as a plain shared library
and bound via ctypes (no pybind11 in this environment).

``load_obj_native`` / ``load_triangles_txt_native`` return the same numpy
arrays as the pure-Python parsers in ``obj_loader.py`` / ``triangles_txt.py``
(which remain the portable fallback). :func:`available` reports whether the
library is built; :func:`build` compiles it with g++ on demand, and again
whenever ``native/rtc_loader.cpp`` is newer than the library, so a stale
library copied along with a working tree never runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "librtc_loader.so"))
_SRC_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "rtc_loader.cpp"))

_lib: Optional[ctypes.CDLL] = None


def is_stale(lib_path: str = _LIB_PATH, src_path: str = _SRC_PATH) -> bool:
    """True when the library is missing or older than its source."""
    if not os.path.exists(lib_path):
        return True
    return os.path.exists(src_path) and (
        os.path.getmtime(src_path) > os.path.getmtime(lib_path)
    )


def build(force: bool = False) -> bool:
    """Compile the native library when stale (returns True on success)."""
    if not force and not is_stale():
        return True
    try:
        # -B: rebuild unconditionally; staleness was decided above.
        subprocess.run(
            ["make", "-B", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True,
            capture_output=True,
        )
        return os.path.exists(_LIB_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if is_stale() and not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    pf = ctypes.POINTER(ctypes.c_float)
    for fn in (lib.rtc_load_obj, lib.rtc_load_triangles_txt):
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(pf),
            ctypes.POINTER(pf),
            ctypes.POINTER(pf),
            ctypes.POINTER(pf),
            ctypes.POINTER(pf),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
    lib.rtc_free.restype = None
    lib.rtc_free.argtypes = [pf]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _call(fn_name: str, path: str):
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native loader not built; run `make -C native` or use the Python "
            "parsers in obj_loader/triangles_txt"
        )
    pf = ctypes.POINTER(ctypes.c_float)
    verts, normals, albedo, emission, smooth = pf(), pf(), pf(), pf(), pf()
    count = ctypes.c_int(0)
    errbuf = ctypes.create_string_buffer(1024)
    rc = getattr(lib, fn_name)(
        path.encode(),
        ctypes.byref(verts),
        ctypes.byref(normals),
        ctypes.byref(albedo),
        ctypes.byref(emission),
        ctypes.byref(smooth),
        ctypes.byref(count),
        errbuf,
        len(errbuf),
    )
    if rc == 1:
        raise FileNotFoundError(errbuf.value.decode() or path)
    if rc != 0:
        raise ValueError(errbuf.value.decode() or f"{fn_name} failed ({rc})")
    t = count.value

    def take(ptr, n):
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.zeros(
            (0,), np.float32
        )
        lib.rtc_free(ptr)
        return arr.astype(np.float32)

    v = take(verts, 9 * t).reshape(t, 3, 3)
    n = take(normals, 3 * t).reshape(t, 3)
    a = take(albedo, 3 * t).reshape(t, 3)
    e = take(emission, t)
    s = take(smooth, t)
    return v, n, a, e, s


def load_obj_native(path: str):
    """Native OBJ/MTL parse → (verts [T,3,3], normals, albedo, emission,
    smoothness), same contract as ``obj_loader.load_obj``."""
    return _call("rtc_load_obj", path)


def load_triangles_txt_native(path: str):
    """Native triangles.txt parse, same contract as
    ``triangles_txt.load_triangles_txt``."""
    return _call("rtc_load_triangles_txt", path)
