"""MS-SSIM tests: against an independent NumPy implementation written from
the Wang 2003 recipe, plus invariants. (Extension — no reference parity.)"""

import numpy as np
import pytest

from ssim_tpu import reference
from ssim_tpu.models import MS_SSIM_WEIGHTS, compute_ms_ssim
from ssim_tpu.windows import gaussian_taps

from conftest import random_pair


def _numpy_msssim(a, b, data_range=255.0, weights=MS_SSIM_WEIGHTS):
    """Independent f64 implementation (shares only windows.gaussian_taps)."""
    t = gaussian_taps(np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def blur(x):
        xp = np.pad(x, 5, mode="edge")
        rows = np.zeros((x.shape[0] + 10, x.shape[1]))
        for i in range(11):
            rows += t[i] * xp[:, i : i + x.shape[1]]
        out = np.zeros(x.shape)
        for i in range(11):
            out += t[i] * rows[i : i + x.shape[0], :]
        return out

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    result = 1.0
    for lvl, w in enumerate(weights):
        mu_a, mu_b = blur(a), blur(b)
        sa2 = blur(a * a) - mu_a**2
        sb2 = blur(b * b) - mu_b**2
        sab = blur(a * b) - mu_a * mu_b
        cs = np.mean((2 * sab + c2) / (sa2 + sb2 + c2))
        if lvl == len(weights) - 1:
            full_ssim = np.mean(
                ((2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1))
                * ((2 * sab + c2) / (sa2 + sb2 + c2))
            )
            result *= max(full_ssim, 1e-6) ** w
        else:
            result *= max(cs, 1e-6) ** w
            h2, w2 = a.shape[0] // 2, a.shape[1] // 2
            a = a[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))
            b = b[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))
    return result


def test_identical_is_one(rng):
    a, _ = random_pair(rng, 192, 224)
    assert compute_ms_ssim(a, a) == pytest.approx(1.0, abs=1e-5)


def test_against_numpy_impl(rng):
    a, b = random_pair(rng, 200, 240)
    got = compute_ms_ssim(a, b)
    want = _numpy_msssim(a, b)
    assert got == pytest.approx(want, abs=5e-4)


def test_mean_vs_luminance_last_level_differs(rng):
    """The l*cs coupling at the coarsest scale: mean(l*cs) != mean(l)*mean(cs);
    implementation must use the former (Wang 2003 eq. 7)."""
    a, b = random_pair(rng, 200, 200, correlated=False)
    got = compute_ms_ssim(a, b)
    want = _numpy_msssim(a, b)
    assert got == pytest.approx(want, abs=5e-4)


def test_degradation_ordering(rng):
    """More noise -> lower MS-SSIM."""
    a, _ = random_pair(rng, 192, 192)
    scores = []
    for sigma in (2, 10, 40):
        noisy = np.clip(
            a.astype(np.int32) + rng.normal(0, sigma, a.shape).astype(np.int32), 0, 255
        ).astype(np.uint8)
        scores.append(compute_ms_ssim(a, noisy))
    assert scores[0] > scores[1] > scores[2]


def test_too_small_raises():
    with pytest.raises(ValueError):
        compute_ms_ssim(np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8))


def test_fewer_levels_small_image(rng):
    a, b = random_pair(rng, 64, 64)
    got = compute_ms_ssim(a, b, weights=MS_SSIM_WEIGHTS[:3])
    want = _numpy_msssim(a, b, weights=MS_SSIM_WEIGHTS[:3])
    assert got == pytest.approx(want, abs=5e-4)


def test_batched(rng):
    a1, b1 = random_pair(rng, 192, 192)
    a2, b2 = random_pair(rng, 192, 192)
    scores = compute_ms_ssim(np.stack([a1, a2]), np.stack([b1, b2]))
    assert scores.shape == (2,)
    assert scores[0] == pytest.approx(compute_ms_ssim(a1, b1), abs=1e-6)


def test_pallas_impl_matches_xla(rng, interpret_kernel):
    """impl="pallas" (where the fused kernel is available) computes the
    same pyramid as impl="xla": MS-SSIM has one device path."""
    a, b = random_pair(rng, 192, 256)
    got = compute_ms_ssim(a, b, impl="pallas")
    want = compute_ms_ssim(a, b, impl="xla")
    assert got == pytest.approx(want, abs=2e-5)


def test_pallas_impl_matches_numpy(rng, interpret_kernel):
    a, b = random_pair(rng, 180, 200)
    got = compute_ms_ssim(a, b, impl="pallas")
    want = _numpy_msssim(a, b)
    assert got == pytest.approx(want, abs=5e-5)


def test_pallas_impl_batched(rng, interpret_kernel):
    pairs = [random_pair(rng, 176, 192) for _ in range(2)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    got = compute_ms_ssim(a, b, impl="pallas")
    for i in range(2):
        want = compute_ms_ssim(a[i], b[i], impl="pallas")
        assert got[i] == pytest.approx(want, abs=1e-7)


def test_pallas_impl_float_input(rng, interpret_kernel):
    """f32 inputs in [0,1] (training convention) under impl="pallas"."""
    a, b = random_pair(rng, 192, 208)
    af = a.astype(np.float32) / 255.0
    bf = b.astype(np.float32) / 255.0
    got = compute_ms_ssim(af, bf, data_range=1.0, impl="pallas")
    want = compute_ms_ssim(af, bf, data_range=1.0, impl="xla")
    assert got == pytest.approx(want, abs=2e-5)


def test_pallas_impl_grad_matches_xla(rng, interpret_kernel):
    """The auto/pallas path stays differentiable (autodiff through the
    XLA pyramid)."""
    import jax

    a, b = random_pair(rng, 176, 192)
    af = a.astype(np.float32) / 255.0
    bf = b.astype(np.float32) / 255.0
    from ssim_tpu.models.msssim import ms_ssim

    g_pallas = jax.grad(
        lambda x: 1.0 - ms_ssim(x, bf, data_range=1.0, impl="pallas")
    )(af)
    g_xla = jax.grad(
        lambda x: 1.0 - ms_ssim(x, bf, data_range=1.0, impl="xla")
    )(af)
    np.testing.assert_allclose(np.asarray(g_pallas), np.asarray(g_xla), atol=1e-7)


def test_pallas_wide_inputs_use_chunked_path(rng, interpret_kernel):
    """Wide float/u8 pyramids under impl="pallas" agree with XLA."""
    from ssim_tpu.models.msssim import ms_ssim

    a = rng.uniform(0, 255, (180, 4500)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 10, a.shape).astype(np.float32), 0, 255)
    got = float(ms_ssim(a, b, impl="pallas"))
    want = float(ms_ssim(a, b, impl="xla"))
    assert got == pytest.approx(want, abs=2e-5)

    a8w = rng.integers(0, 256, (180, 8600), dtype=np.uint8)
    b8w = np.clip(a8w.astype(np.int32) + rng.integers(-10, 10, a8w.shape), 0, 255).astype(np.uint8)
    got = float(ms_ssim(a8w, b8w, impl="pallas"))
    want = float(ms_ssim(a8w, b8w, impl="xla"))
    assert got == pytest.approx(want, abs=2e-5)


def test_pallas_mixed_dtypes_fall_back(rng, interpret_kernel):
    """Mixed-dtype pairs run the same XLA pyramid under any impl."""
    from ssim_tpu.models.msssim import ms_ssim

    a8 = rng.integers(0, 256, (176, 192), dtype=np.uint8)
    bf = a8.astype(np.float32)
    got = float(ms_ssim(a8, bf, impl="pallas"))
    want = float(ms_ssim(a8, bf, impl="xla"))
    assert got == pytest.approx(want, abs=1e-7)


def test_msssim_relaxed_tier(rng, interpret_kernel):
    """accuracy="relaxed" is accepted and computes at standard accuracy;
    bad values raise; gradients still flow."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.errors import InvalidArgumentError
    from ssim_tpu.models.msssim import ms_ssim

    a = rng.integers(0, 256, (192, 704), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-12, 12, a.shape),
                0, 255).astype(np.uint8)
    want = float(ms_ssim(a, b, impl="pallas"))
    got = float(ms_ssim(a, b, impl="pallas", accuracy="relaxed"))
    assert got == pytest.approx(want, abs=1e-4)

    with pytest.raises(InvalidArgumentError):
        ms_ssim(a, b, accuracy="fast")

    af = jnp.asarray(a, jnp.float32) / 255.0
    bf = jnp.asarray(b, jnp.float32) / 255.0
    g = jax.grad(
        lambda x: ms_ssim(x, bf, data_range=1.0, impl="pallas",
                          accuracy="relaxed")
    )(af)
    assert bool(jnp.isfinite(g).all())


@pytest.mark.parametrize("h,w,batch", [(64, 128, None), (63, 127, None),
                                       (70, 96, 3), (41, 200, None)])
def test_pooled_components_bit_identical_to_downsample2(rng, h, w, batch):
    """The pyramid's 2x2 pool (_downsample2, a reduce_window) is
    bit-identical to the NumPy 2x2 mean of u8 inputs across even/odd H/W
    and batches (sums of four u8 values and the 0.25 scale are exact in
    f32), and the f64 pool used by the double-precision reference is
    exact too."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.models.msssim import _downsample2

    shape = (h, w) if batch is None else (batch, h, w)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    hh, ww = h // 2, w // 2
    blocks = a[..., : 2 * hh, : 2 * ww].astype(np.float64).reshape(
        shape[:-2] + (hh, 2, ww, 2))
    want = blocks.mean(axis=(-3, -1))
    got = _downsample2(jnp.asarray(a, jnp.float32))
    assert got.dtype == jnp.float32
    assert np.array_equal(np.asarray(got, np.float64), want)
    with jax.enable_x64(True):
        got64 = _downsample2(jnp.asarray(a, jnp.float64))
        assert np.array_equal(np.asarray(got64), want)
