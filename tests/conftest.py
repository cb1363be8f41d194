"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only launch/dryrun.py forces 512 placeholder devices (and tests
that need a few devices spawn subprocesses)."""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
                   "without one")
