"""The benchmark's own CPU tests (``python -m pytest port_bench/tests``); the
repository's tier-1 run collects ``tests/`` only."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
