def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper card (capability 9.0); skips elsewhere",
    )
