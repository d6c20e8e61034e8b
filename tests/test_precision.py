"""High-precision (precision="f64") mode tests.

The reference's RMGR_SSIM_USE_DOUBLE build recompiles every kernel with
Float=double and is validated at global<=5e-7 / pixel<=1e-5 vs a
quad-precision oracle (tests/rmgr-ssim-tests.cpp:98-104, README.md:92).
Here the device impls run the XLA formulation in float64 on the device
(ssim_parts_xla(dtype=float64) under a scoped jax.enable_x64), which
agrees with the f64 NumPy oracle to the last few bits. These tests pin
the tier bounds (the contract) and tighter bounds (the regression guard).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssim_tpu import compute_ssim, engine, reference
from ssim_tpu.ops.ssim_xla import ssim_parts_xla

from conftest import random_pair

# The reference double build's tolerance tier (tests/rmgr-ssim-tests.cpp:98-104).
DOUBLE_TIER_GLOBAL = 5e-7
DOUBLE_TIER_PIXEL = 1e-5
# The device f64 tier against the f64 oracle: same arithmetic, other
# summation order (regression guard, not the contract).
MEASURED_GLOBAL = 1e-12
MEASURED_PIXEL = 1e-12


def _device_f64(a, b, **kw):
    with jax.enable_x64(True):
        partials, m = ssim_parts_xla(a, b, dtype=jnp.float64, **kw)
        return np.asarray(partials), None if m is None else np.asarray(m)


@pytest.mark.parametrize("shape", [(67, 150), (256, 384), (77, 4200)])
def test_precise_kernel_vs_oracle(rng, shape):
    """The device f64 formulation hits the double tier with a margin of
    five orders of magnitude, score and map, at narrow and wide shapes."""
    a, b = random_pair(rng, *shape)
    g0, m0 = reference.compute_ssim(a, b, with_map=True)
    partials, m = _device_f64(a, b, with_map=True)
    assert partials.dtype == np.float64 and m.dtype == np.float64
    g = float(partials.sum() / (shape[0] * shape[1]))
    assert abs(g - g0) < MEASURED_GLOBAL < DOUBLE_TIER_GLOBAL
    assert np.abs(m - m0).max() < MEASURED_PIXEL < DOUBLE_TIER_PIXEL


def test_precise_beats_f32_mode(rng):
    """precision='f64' must be materially more accurate than the f32 mode,
    not just a relabel."""
    a, b = random_pair(rng, 128, 200)
    g0, m0 = reference.compute_ssim(a, b, with_map=True)
    g32, m32 = engine.compute(a, b, with_map=True)
    g64, m64 = engine.compute(a, b, with_map=True, precision="f64")
    assert abs(float(g64) - g0) < max(abs(float(g32) - g0) / 100, 1e-12)
    # The map is returned as f32 in both tiers; the f64 one is the
    # correctly rounded value, so it is at least as close.
    assert np.abs(m64 - m0).max() <= np.abs(m32 - m0).max()


def test_engine_precision_f64_pallas(rng, interpret_kernel, monkeypatch):
    """precision='f64' + impl='pallas' runs on the device (never the host
    oracle) and returns f64."""
    a, b = random_pair(rng, 96, 128)
    want, _ = reference.compute_ssim(a, b)

    def no_oracle(*args, **kwargs):
        raise AssertionError("precision='f64' fell back to the host oracle")

    monkeypatch.setattr(reference, "compute_ssim", no_oracle)
    got, _ = engine.compute(a, b, impl="pallas", precision="f64")
    assert isinstance(got, np.float64)
    assert abs(float(got) - want) < MEASURED_GLOBAL


def test_engine_precision_f64_u16_stays_df32(rng):
    """u16 inputs ride the device f64 tier: squares of 16-bit values are
    exact in f64, so the bound is the u8 one."""
    a = rng.integers(0, 60000, (48, 64)).astype(np.uint16)
    b = rng.integers(0, 60000, (48, 64)).astype(np.uint16)
    got, _ = engine.compute(a, b, impl="xla", precision="f64", data_range=65535.0)
    want, _ = reference.compute_ssim(a, b, data_range=65535.0)
    assert abs(float(got) - want) < MEASURED_GLOBAL


def test_engine_precision_f64_fallback_f64_input(rng):
    """f64 inputs keep every bit on the device f64 tier (no f32 cast)."""
    a = rng.random((48, 64)).astype(np.float64)
    b = rng.random((48, 64)).astype(np.float64)
    got, _ = engine.compute(a, b, impl="xla", precision="f64", data_range=1.0)
    want, _ = reference.compute_ssim(a, b, data_range=1.0)
    assert abs(float(got) - want) < 1e-12


def test_precise_batched(rng):
    pairs = [random_pair(rng, 40, 56) for _ in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    scores, _ = engine.compute(a, b, precision="f64")
    for i in range(3):
        want, _ = reference.compute_ssim(a[i], b[i])
        assert abs(float(scores[i]) - want) < MEASURED_GLOBAL


@pytest.mark.parametrize("dtypes", [
    (np.uint8, np.float32), (np.float16, np.float16), (np.int32, np.int32),
])
def test_precise_mixed_and_other_dtypes(rng, dtypes):
    """Every input dtype the engine accepts rides the device f64 tier,
    mixed pairs included."""
    a8, b8 = random_pair(rng, 30, 44)
    a, b = a8.astype(dtypes[0]), b8.astype(dtypes[1])
    got, _ = engine.compute(a, b, precision="f64")
    want, _ = reference.compute_ssim(a8, b8)
    assert abs(float(got) - want) < MEASURED_GLOBAL


def test_precise_oversized_radius_on_device(rng):
    """Radii beyond the fused kernel's bound run in the device f64 tier
    too."""
    a, b = random_pair(rng, 50, 60)
    got = compute_ssim(a, b, precision="f64", radius=20, sigma=6.0)
    want, _ = reference.compute_ssim(a, b, radius=20, sigma=6.0)
    assert abs(got - want) < MEASURED_GLOBAL


def test_precise_leaves_x64_off(rng):
    """The f64 tier switches x64 on for its own call only."""
    a, b = random_pair(rng, 20, 24)
    compute_ssim(a, b, precision="f64")
    assert not jax.config.jax_enable_x64
    assert jnp.zeros(()).dtype == jnp.float32


def test_precise_host_impl_uses_oracle(rng):
    """impl='host' computes in f32 in C; its double tier is the oracle."""
    from ssim_tpu.ops import host

    if not host.is_available():
        pytest.skip("native host backend not built")
    a, b = random_pair(rng, 24, 30)
    got, _ = engine.compute(a, b, impl="host", precision="f64")
    want, _ = reference.compute_ssim(a, b)
    assert abs(float(got) - want) < 1e-15


def test_precise_frozen_scalar(images_dir):
    """Against the quad-precision frozen constant (the reference's own
    double-build acceptance check, tests/rmgr-ssim-tests.cpp:286-310)."""
    import os

    from ssim_tpu.testing.frozen import EINSTEIN_SUITE
    from ssim_tpu.utils import load_image

    ein = load_image(os.path.join(images_dir, "einstein.png"))
    blur = load_image(os.path.join(images_dir, "blur.png"))
    got, _ = engine.compute(blur, ein, precision="f64")
    assert abs(float(got) - EINSTEIN_SUITE["blur.png"]) < 1e-12
