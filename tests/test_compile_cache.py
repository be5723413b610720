"""Compilation-cache directory selection."""

import os

import jax

from mipsfusion_tpu import compile_cache


def _updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _updates(monkeypatch)
    compile_cache.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in calls
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_is_the_checkout_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _updates(monkeypatch)
    compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        compile_cache.__file__)))
    assert calls["jax_compilation_cache_dir"] == os.path.join(root,
                                                              ".jax_cache")
