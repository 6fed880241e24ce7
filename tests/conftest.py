"""Registers the marker of tests that need a CUDA card (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is false")
