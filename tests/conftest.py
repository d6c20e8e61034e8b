"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so sharding
tests exercise a real multi-device mesh without accelerators (the
simulation strategy SURVEY.md §4.8 prescribes; the reference's analogue
is its impl x threading test matrix). JAX_PLATFORMS defaults to cpu
here; set it to cuda to run the tests marked `gpu` on a card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist

Must run before any jax import, hence the env mutation at module import.
Which tests exist never depends on the platform: the `gpu` marker is
resolved by a fixture at run time, so xdist workers collect alike.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip tests marked `gpu` unless JAX runs on a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {platform}); run with "
                    "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu "
                    "-p no:xdist")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """impl="pallas" (and "auto") available on the CPU, with the fused
    kernel running in the Pallas interpreter — the GPU routing, wrappers
    and gradient rule exercised end to end without a card."""
    from ssim_tpu import dispatch
    import ssim_tpu.ops.ssim_pallas as kernel

    monkeypatch.setattr(dispatch, "backend_platform", lambda: "gpu")
    monkeypatch.setattr(
        kernel, "ssim_parts_pallas",
        functools.partial(kernel.ssim_parts_pallas, interpret=True),
    )
    dispatch._probe.cache_clear()
    yield
    dispatch._probe.cache_clear()


@pytest.fixture(scope="session")
def images_dir():
    from ssim_tpu.testing import frozen

    if not frozen.have_images():
        pytest.skip("reference test images not available")
    return frozen.images_dir()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x55)


def random_pair(rng, h, w, correlated=True):
    """A correlated uint8 image pair (uncorrelated pairs give SSIM ~ 0,
    which under-exercises the formula)."""
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if not correlated:
        b = rng.integers(0, 256, (h, w), dtype=np.uint8)
    else:
        noise = rng.normal(0, 12, (h, w))
        b = np.clip(a.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)
    return a, b
