"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
else a fixed directory in the checkout."""

import os

import jax

from aaltoasr_tpu.utils import compile_cache


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_environment_wins_and_nothing_is_set(monkeypatch, tmp_path):
    calls = _record(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_fixed_path_in_checkout(monkeypatch):
    calls = _record(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
