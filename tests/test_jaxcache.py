"""Compile-cache location rule (utils.jaxcache)."""

import pathlib

import jax

from relativitypathtracer_tpu.utils import jaxcache

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_env_dir_is_honoured(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.cache_dir() is None
    jaxcache.enable()
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert jaxcache.cache_dir() == str(REPO / ".jax_cache")
        jaxcache.enable()
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
