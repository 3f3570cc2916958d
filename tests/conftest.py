import os
import sys

# Tests run on the single real CPU device (the dry-run sets its own
# XLA_FLAGS in a separate process). Keep compilation deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running subprocess tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skipped without one",
    )
