"""Differential tests: XLA f32 path vs the f64 oracle.

Same strategy as the reference's optimized-vs-naive matrix
(tests/rmgr-ssim-tests.cpp:228-327) with the f32-build tolerances
(global 2e-6, per-pixel 1e-3; tests/rmgr-ssim-tests.cpp:98-104)."""

import os

import numpy as np
import pytest

from ssim_tpu import compute_ssim, reference, ssim, ssim_and_map, ssim_loss
from ssim_tpu.testing import frozen
from ssim_tpu.utils import load_image

from conftest import random_pair


def _check(a, b, impl="xla"):
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    got, got_map = compute_ssim(a, b, with_map=True, impl=impl)
    # Global tolerance scales with pixel count: per-pixel f32 error is
    # ~1e-3 worst-case (reference README.md:91) and averages out over the
    # image; the flat 2e-6 applies at real image sizes (the only sizes the
    # reference asserts globals for).
    npix = a.shape[-1] * a.shape[-2]
    tol = max(frozen.GLOBAL_TOLERANCE_F32, 2e-3 / npix**0.5)
    assert abs(got - want) < tol, (got, want, tol)
    assert got_map.shape == want_map.shape
    assert np.abs(got_map - want_map).max() < frozen.PIXEL_TOLERANCE_F32


def test_einstein_suite_vs_oracle(images_dir):
    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name in frozen.EINSTEIN_SUITE:
        img = load_image(os.path.join(images_dir, name))
        _check(img, ref)


def test_einstein_frozen_global(images_dir):
    """End-to-end against frozen constants (PNG -> exact pixel parity)."""
    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name, want in frozen.EINSTEIN_SUITE.items():
        img = load_image(os.path.join(images_dir, name))
        got = compute_ssim(img, ref, impl="xla")
        assert abs(got - want) < frozen.GLOBAL_TOLERANCE_F32, (name, got, want)


@pytest.mark.parametrize(
    "shape",
    [(1, 1), (1, 17), (11, 11), (12, 257), (63, 255), (65, 257), (64, 64), (128, 200), (255, 63)],
)
def test_odd_shapes_vs_oracle(rng, shape):
    """Partial tiles and non-multiple widths, mirroring the bbb255/bbb257
    crop cases (tests/rmgr-ssim-tests.cpp:430-465)."""
    a, b = random_pair(rng, *shape)
    _check(a, b)


def test_uncorrelated_vs_oracle(rng):
    a, b = random_pair(rng, 96, 160, correlated=False)
    _check(a, b)


def test_batched_matches_single(rng):
    pairs = [random_pair(rng, 72, 130) for _ in range(3)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    scores = compute_ssim(a, b, impl="xla")
    assert scores.shape == (3,)
    for i in range(3):
        single = compute_ssim(a[i], b[i], impl="xla")
        # Not bitwise: batched and single are separate XLA compiles, and
        # per-shape codegen may contract mul+add into FMAs differently
        # (about 1e-8 with the per-signal blurs). Orders of
        # magnitude inside the 2e-6 oracle tier.
        assert scores[i] == pytest.approx(single, abs=5e-8)


def test_jittable_ssim_close_to_eager(rng):
    a, b = random_pair(rng, 100, 140)
    eager = compute_ssim(a, b, impl="xla")
    device = float(ssim(a, b))
    assert device == pytest.approx(eager, abs=1e-5)  # f32 on-device reduce
    g, m = ssim_and_map(a, b)
    assert m.shape == (100, 140)
    assert float(g) == pytest.approx(eager, abs=1e-5)


def test_ssim_loss_differentiable(rng):
    import jax

    a = rng.random((2, 32, 48), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape).astype(np.float32), 0, 1)
    loss = ssim_loss(a, b)
    assert 0.0 <= float(loss) < 1.0
    grads = jax.grad(lambda x: ssim_loss(x, b))(a)
    assert grads.shape == a.shape
    assert np.isfinite(np.asarray(grads)).all()
    assert np.abs(np.asarray(grads)).max() > 0


def test_identical_is_one(rng):
    a, _ = random_pair(rng, 50, 70)
    assert compute_ssim(a, a, impl="xla") == pytest.approx(1.0, abs=1e-6)


def test_bbb1080_differential(images_dir):
    """Production-size differential check on real content (1080p RGB)."""
    png = load_image(os.path.join(images_dir, "big_buck_bunny_1080_07806.png"))
    jpg = load_image(os.path.join(images_dir, "big_buck_bunny_1080_07806_50.jpg"))
    a, b = jpg[:, :, 1], png[:, :, 1]
    _check(a, b)
