"""Test environment.

By default: the CPU backend with 8 virtual devices (the JAX-native "fake
cluster" for multi-device sharding tests) and float64 enabled, so parity
tests against the float64 references are not precision-limited.

Tests that need a CUDA GPU carry the ``chip`` marker and skip elsewhere
(the ``gpu`` fixture decides).  On a machine with a card they run with

    python -m pytest tests -m chip

which leaves JAX on its default (GPU) backend.
"""

import os

import pytest


def _on_card(config) -> bool:
    return (config.getoption("markexpr", "") or "").strip() == "chip"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA GPU; run on the card with `python -m pytest tests -m chip`")
    config.addinivalue_line("markers", "slow: long-running; deselected by `-m 'not slow'`")
    if not _on_card(config):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    if not _on_card(config):
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX backend is {dev.platform}); run with -m chip on the card")
    return dev


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Run the Triton kernel in the Pallas interpreter wherever the public
    entry points call it (``enhance_process(backend="pallas")``,
    ``make_sharded_enhance_pallas``), so CPU tests can drive them."""
    from distantspeech_tpu.ops import pallas_mvdr

    kernel = pallas_mvdr.pallas_mvdr_omlsa
    monkeypatch.setattr(pallas_mvdr, "pallas_mvdr_omlsa", lambda *a, **k: kernel(*a, **{**k, "interpret": True}))
