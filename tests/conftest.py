import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

try:
    import hypothesis  # noqa: F401  (the real package, when installed)
except ModuleNotFoundError:
    # Container images without hypothesis (nothing may be pip-installed
    # there) get the deterministic shim; the pinned CI env has the real one.
    import _hypothesis_fallback

    _hypothesis_fallback.install()

import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (subprocess sweeps, full-suite lane only)")
    config.addinivalue_line(
        "markers",
        "sharding: multi-device subprocess tests (need spare RAM/CPU)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (run with -m gpu on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Keep the single-host test session inside RAM: compiled executables
    accumulate across modules otherwise (OOM on 35 GB hosts)."""
    yield
    jax.clear_caches()
