"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real device
count (1 on this container); multi-device tests spawn subprocesses.

Also hosts the optional-hypothesis shim: property-based tests import
``given/settings/st`` from here so the suite still collects (and its
deterministic tests still run) when ``hypothesis`` is not installed —
it lives in ``requirements-dev.txt``, not the runtime deps.
"""
import jax
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    class _Strategy:
        """Chainable stand-in so module-level strategy expressions like
        ``st.integers(...).flatmap(...)`` still evaluate at import time."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    st = _Strategy()

    def settings(*args, **kwargs):
        return lambda fn: fn

    def given(*args, **kwargs):
        def deco(fn):
            def skipped():
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")
            skipped.__name__ = fn.__name__
            skipped.__doc__ = fn.__doc__
            return skipped
        return deco


def pytest_configure(config):
    # the chaos suite marks per-test timeouts; register the marker so the
    # suite is warning-clean when pytest-timeout (requirements-dev.txt,
    # used by CI) is not installed locally — without the plugin the
    # marker is inert, with it each chaos test gets a hang watchdog
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test watchdog (pytest-timeout plugin)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (decided in a fixture)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
