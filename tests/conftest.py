# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see ONE
# device; multi-device tests either run in subprocesses (test_parallel) or
# carry the `multidevice` marker and only execute under the forced-host-
# device CI leg (`tools/ci.sh --multidevice`).
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice(n=2): needs >= n jax devices in THIS process; skips "
        "(never errors) on fewer — run via tools/ci.sh --multidevice, which "
        "forces 8 host devices and selects only these tests")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips (never errors) without one — run "
        "the port's kernel tests on the H100 (see README)")


def pytest_runtest_setup(item):
    for mark in item.iter_markers(name="multidevice"):
        require_devices(int(mark.kwargs.get("n", mark.args[0] if mark.args else 2)))


def require_devices(n: int = 2):
    """Device-count twin of ``pytest.importorskip``: skip — never error —
    when the runtime exposes fewer than ``n`` jax devices.  Returns the
    device list so callers can build meshes from a prefix of it."""
    import jax
    if jax.device_count() < n:
        pytest.skip(f"needs >= {n} jax devices, have {jax.device_count()} "
                    f"(run under XLA_FLAGS=--xla_force_host_platform_"
                    f"device_count=8, see tools/ci.sh --multidevice)")
    return jax.devices()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
