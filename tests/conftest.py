import os
import sys

# tests must see the single real CPU device (the 512-device override is
# strictly dryrun.py's); keep any user XLA_FLAGS out of the test env
os.environ.pop("XLA_FLAGS", None)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (and nvcc) to build and run "
        "the port's CUDA kernels; such a test skips without one")
