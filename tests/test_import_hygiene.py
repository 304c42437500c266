"""Importing the package must NEVER initialize a jax backend.

A module-level ``jnp.uint32(...)`` constant once forced device-client
creation at import time, which costs every CLI invocation (including
pure host-placement runs that never need the device) the backend's
start-up, and on a GPU reserves the card's memory.  Run in a clean
subprocess so other tests' device use cannot mask a regression."""

import subprocess
import sys


def test_import_does_not_initialize_backend():
    code = (
        "import scalce_tpu.cli, scalce_tpu.pipeline.driver, "
        "scalce_tpu.pipeline.decode, scalce_tpu.streams.qualities, "
        "scalce_tpu.streams.seqs, scalce_tpu.streams.names, "
        "scalce_tpu.ops.rans, scalce_tpu.ops.core_match, "
        "scalce_tpu.ops.reorder, scalce_tpu.parallel.mesh\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, 'import initialized a backend'\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_native_builds_when_compiler_present():
    """The numpy fallbacks exist for toolchain-less hosts — but on a
    host WITH a compiler, a silent native build failure must fail CI
    (it once hid an #include-order bug behind 10x-slower fallbacks)."""
    import os
    import shutil

    import pytest

    if shutil.which(os.environ.get("CC", "cc")) is None:
        pytest.skip("no C compiler on this host")
    from scalce_tpu import native
    assert native.AVAILABLE


def test_compile_cache_defaults_to_fixed_repo_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to the fixed
    <repo>/.jax_cache (a moving path would never hit)."""
    import os

    import jax

    from scalce_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_leaves_env_dir_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper configures
    nothing (JAX reads the variable itself) and reports that dir."""
    import jax

    from scalce_tpu.utils import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
