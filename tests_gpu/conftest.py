"""Fixtures of the GPU tier.  Whether a GPU exists is decided inside the
`gpu` fixture, never at import: collection is the same on every host."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture
def cpu():
    """The host CPU device, for the reference legs."""
    import jax

    return jax.devices("cpu")[0]
