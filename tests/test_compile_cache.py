"""One rule for the persistent compile cache (CLI, bench.py, chip_smoke.py,
tests): JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""

import os

import jax

from raytracingc_tpu.utils import compile_cache
from raytracingc_tpu.utils.compile_cache import compile_cache_dir


def test_env_var_wins():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == (
        "/x/cache", True
    )


def test_default_is_the_checkout():
    directory, from_env = compile_cache_dir({})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert not from_env
    assert directory == os.path.join(repo, ".jax_cache")
    assert os.path.isdir(os.path.join(os.path.dirname(directory), "raytracingc_tpu"))


def test_enable_sets_nothing_when_env_names_the_dir(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/cache")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/x/cache"
    assert calls == []


def test_enable_points_jax_at_the_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    directory = compile_cache.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", directory)]
    assert directory.endswith(".jax_cache")
