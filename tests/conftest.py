"""Test configuration: run on a virtual 8-device CPU mesh by default.

Set GSM_TPU_TESTS=1 to run against the real TPU backend instead.
"""

import os

if not os.environ.get("GSM_TPU_TESTS"):
    # The environment's device plugin overrides the JAX_PLATFORMS env var at
    # interpreter startup; the config knob is the reliable way to pin CPU.
    #
    # NOTE: tests run on a single CPU device.  With
    # --xla_force_host_platform_device_count=8, XLA:CPU's executable cache
    # collides across programs of different shapes ("Execution supplied 8
    # buffers but compiled program expected 9").  The 8-device mesh path is
    # exercised by tests/test_multichip.py in a subprocess instead.
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", (
        "tests must run on CPU; got " + jax.default_backend())

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy interpret-mode / subprocess test — skipped in the "
        "default run; set GSM_SLOW_TESTS=1 for the full tier")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: the default run stays within the documented wall-time
    budget (CLAUDE.md); the slow tier (large interpret-mode scenes, extra
    parameter combinations, multichip subprocess stress tests) runs with
    GSM_SLOW_TESTS=1.  Every subsystem keeps at least one representative
    test in the default tier."""
    if os.environ.get("GSM_SLOW_TESTS"):
        return
    skip = pytest.mark.skip(reason="slow tier: set GSM_SLOW_TESTS=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_test():
    """Work around an XLA:CPU executable-cache collision (jax 0.9.0): once many
    programs have been compiled in one process, dispatching a new program can
    bind a stale executable ("Execution supplied 8 buffers but compiled program
    expected 9").  Clearing the cache between tests avoids the collision at the
    cost of recompiles."""
    yield
    import jax
    jax.clear_caches()
