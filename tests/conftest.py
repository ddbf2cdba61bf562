import os
import sys

# Tests run on the default 1-device CPU backend; multi-device distribution
# tests spawn subprocesses that set XLA_FLAGS themselves (see test_dist_*).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
