"""pytest settings of the benchmark's tests (python -m pytest wmbench/tests).

`card`: a test that needs a CUDA card; it decides inside the test, never
at import, and skips on a machine without one.
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
