"""Test configuration: run on a virtual 8-device CPU mesh by default.

Must set env vars before jax is imported anywhere (reference CI runs the
whole suite CPU-only as well, .github/workflows/linux-build.yml:44-99).
A persistent compilation cache keeps re-runs fast: the directory named by
JAX_COMPILATION_CACHE_DIR when it is set, else ``<repo>/.jax_cache``.

Tests marked ``gpu`` need the card and skip elsewhere; run them on a GPU
host with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402  (after env setup, before any compilation)

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(
            os.path.join(os.path.dirname(__file__), os.pardir,
                         ".jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")
    return jax.devices()[0]
