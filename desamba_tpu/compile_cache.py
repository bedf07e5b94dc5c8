"""Compilation settings, set up in one place: JAX's persistent cache and
the XLA flags every process of the package compiles with.

The big ladder and rescore programs compile once per bucketed shape, so
every process that runs the device engine keeps its compiled programs.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads that directory
itself and nothing is set here. Otherwise the cache goes to one fixed
directory inside the checkout (``.cache/jax``, listed in .gitignore).

XLA's GPU autotuner is off (``--xla_gpu_autotune_level=0``): it picks
among equivalent kernels, which does not change the integer results, and
on an H100 it adds about half again to the compile of each big program
(``lv_batch``: 34.9 s with it, 22.4 s without). XLA reads XLA_FLAGS once,
when JAX starts its first backend, so ``set_xla_flags`` runs when the
package is imported; a caller's own ``xla_gpu_autotune_level`` wins.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".cache" / "jax"
AUTOTUNE_FLAG = "--xla_gpu_autotune_level=0"


def set_xla_flags() -> str:
    """Add AUTOTUNE_FLAG to XLA_FLAGS unless the caller chose a level;
    returns XLA_FLAGS."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {AUTOTUNE_FLAG}".strip()
    return os.environ["XLA_FLAGS"]


def cache_dir() -> str:
    """The directory the cache is kept in."""
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at cache_dir(); returns it."""
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return cache_dir()
