"""Persistent XLA compilation cache for the entry points.

A cold frame compiles the renderer (and its Triton kernels) from scratch;
the CLI, bench, chip_smoke.py and the tools compile the same renderers in
separate processes. A shared on-disk cache turns every repeat compile into
a cache read. Enabled by those entry points -- NOT at package import
(library users own their config).

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (then no
other directory is set in code), otherwise one fixed directory inside the
checkout. The path is part of nothing XLA keys on, but a directory that
moves between runs never hits.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str | None:
    """The directory enable() points JAX at, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_DIR)


def enable() -> None:
    """Turn on the persistent compilation cache (idempotent)."""
    import jax

    path = cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
