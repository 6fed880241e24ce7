def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is false")
