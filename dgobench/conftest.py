"""The benchmark's own tests: the ``gpu`` marker, as the repository's
tests register it, for a run of these files alone."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (decided in a fixture)")
