"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is
set, else one fixed directory inside the checkout."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

from desamba_tpu import compile_cache as cc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    assert cc.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.enable_compile_cache() == str(cc.DEFAULT_DIR)
        assert jax.config.jax_compilation_cache_dir == str(cc.DEFAULT_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert cc.DEFAULT_DIR == REPO / ".cache" / "jax"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".cache/" in ignored


def test_env_dir_receives_the_compiled_program(tmp_path):
    """A process with JAX_COMPILATION_CACHE_DIR set writes its compiled
    programs there."""
    code = ("import jax, jax.numpy as jnp\n"
            "from desamba_tpu.compile_cache import enable_compile_cache\n"
            "enable_compile_cache()\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(tmp_path / "cc")
    assert any((tmp_path / "cc").iterdir())


@pytest.mark.parametrize("given,want", [
    ("", cc.AUTOTUNE_FLAG),
    ("--xla_force_host_platform_device_count=2",
     f"--xla_force_host_platform_device_count=2 {cc.AUTOTUNE_FLAG}"),
    ("--xla_gpu_autotune_level=4", "--xla_gpu_autotune_level=4"),
], ids=["unset", "other_flags", "caller_level"])
def test_package_import_sets_the_autotune_level(given, want):
    """Importing the package turns XLA's GPU autotuner off for the whole
    process, unless the caller chose a level."""
    code = ("import os, desamba_tpu\n"
            "print(os.environ['XLA_FLAGS'])\n")
    env = dict(os.environ, XLA_FLAGS=given, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == want
