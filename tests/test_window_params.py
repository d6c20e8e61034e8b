"""Custom window extension: radius/sigma/k1/k2 through the public API.

The reference pins the window (11x11 sigma=1.5, src/ssim.cpp:227-228) and
the stabilization constants (k1=0.01, k2=0.03, :956-960); exposing them is
an extension matching the skimage/torchmetrics SSIM surface (win_size,
sigma, K1, K2). Ground truth here is a DIRECT O(r^2) windowed-gather SSIM
written against the formula (independent of reference.py's separable
formulation), so the oracle's generalization is itself validated.
"""

import numpy as np
import pytest

from conftest import random_pair
from ssim_tpu import compute_ssim, reference
from ssim_tpu.api import ssim, ssim_and_map, ssim_loss
from ssim_tpu.errors import InvalidArgumentError


def naive_ssim_direct(a, b, *, radius, sigma, k1=0.01, k2=0.03,
                      data_range=255.0):
    """Direct per-pixel windowed SSIM: 2-D sampled-Gaussian window
    normalized over the FULL table (the reference's construction,
    src/ssim.cpp:272-318), clamp-to-edge gathers, all float64."""
    h, w = a.shape
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / (2.0 * sigma**2))
    k /= k.sum()
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    out = np.empty((h, w), np.float64)
    ys = np.arange(h)
    xs = np.arange(w)
    for y in range(h):
        yy = np.clip(y + d.astype(int), 0, h - 1)
        for x in range(w):
            xx = np.clip(x + d.astype(int), 0, w - 1)
            wa = af[np.ix_(yy, xx)]
            wb = bf[np.ix_(yy, xx)]
            mu_a = (k * wa).sum()
            mu_b = (k * wb).sum()
            s_a2 = (k * wa * wa).sum() - mu_a * mu_a
            s_b2 = (k * wb * wb).sum() - mu_b * mu_b
            s_ab = (k * wa * wb).sum() - mu_a * mu_b
            out[y, x] = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / (
                (mu_a**2 + mu_b**2 + c1) * (s_a2 + s_b2 + c2)
            )
    assert len(ys) == h and len(xs) == w
    return out.mean(), out


@pytest.mark.parametrize(
    "radius,sigma,k1,k2",
    [(3, 1.2, 0.01, 0.03), (1, 0.8, 0.02, 0.05), (7, 2.5, 0.01, 0.03)],
)
def test_oracle_generalizes(rng, radius, sigma, k1, k2):
    """reference.compute_ssim's radius/sigma/k1/k2 agree with the direct
    O(r^2) formula to f64 precision."""
    a, b = random_pair(rng, 24, 20)
    want, want_map = naive_ssim_direct(
        a, b, radius=radius, sigma=sigma, k1=k1, k2=k2
    )
    got, got_map = reference.compute_ssim(
        a, b, with_map=True, radius=radius, sigma=sigma, k1=k1, k2=k2
    )
    assert got == pytest.approx(want, abs=1e-12)
    np.testing.assert_allclose(got_map, want_map, atol=1e-12)


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (2, 1.0), (7, 2.5)])
def test_xla_custom_radius_matches_oracle(rng, radius, sigma):
    a, b = random_pair(rng, 40, 56)
    want, _ = reference.compute_ssim(a, b, radius=radius, sigma=sigma)
    got = compute_ssim(a, b, impl="xla", radius=radius, sigma=sigma)
    assert got == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (3, 1.5), (8, 2.5), (16, 4.0)])
def test_pallas_fused_custom_radius(rng, radius, sigma, interpret_kernel):
    """impl='pallas' + non-default radius rides the fused kernel for any
    radius <= MAX_FUSED_RADIUS (the taps and the register ring are built
    at trace time) — score and map against the f64 oracle."""
    a, b = random_pair(rng, 33, 47)
    want, want_map = reference.compute_ssim(
        a, b, with_map=True, radius=radius, sigma=sigma
    )
    got, got_map = compute_ssim(
        a, b, with_map=True, impl="pallas", radius=radius, sigma=sigma
    )
    assert got == pytest.approx(want, abs=2e-6)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_pallas_oversized_radius_falls_back_to_xla(rng, interpret_kernel):
    """radius > MAX_FUSED_RADIUS silently rides the XLA path (same
    convention as the dtype fallback) and stays correct."""
    a, b = random_pair(rng, 48, 40)
    want, _ = reference.compute_ssim(a, b, radius=17, sigma=5.0)
    got = compute_ssim(a, b, impl="pallas", radius=17, sigma=5.0)
    assert got == pytest.approx(want, abs=2e-6)


def test_pallas_fused_custom_radius_chunked(rng, interpret_kernel):
    """Custom radius on a wide image that spans many column tiles of the
    kernel (the clamped column reads cross every tile boundary)."""
    a, b = random_pair(rng, 8, 1100)
    want, _ = reference.compute_ssim(a, b, radius=3, sigma=1.2)
    got = compute_ssim(a, b, impl="pallas", radius=3, sigma=1.2)
    assert got == pytest.approx(want, abs=2e-6)


def test_packed_path_custom_radius(rng, interpret_kernel):
    """Custom radius on a small-image batch through the routed kernel
    (one program per image and tile, so images never mix)."""
    from ssim_tpu.ops.routing import ssim_parts_auto
    from ssim_tpu import engine
    import jax.numpy as jnp

    a = np.stack([random_pair(rng, 64, 64)[0] for _ in range(4)])
    b = np.clip(a.astype(np.int32) + 7, 0, 255).astype(np.uint8)
    parts, _ = ssim_parts_auto(
        jnp.asarray(a), jnp.asarray(b), radius=3, sigma=1.2
    )
    got = engine.finalize_mean(np.asarray(parts), 64 * 64)
    for i in range(4):
        want, _ = reference.compute_ssim(a[i], b[i], radius=3, sigma=1.2)
        assert got[i] == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize("h,w", [(40, 56), (64, 200)])
def test_pallas_custom_sigma_k1_k2(rng, h, w, interpret_kernel):
    """sigma/k1/k2 ride the fused kernel (the Pallas interpreter on the
    CPU), score and map."""
    a, b = random_pair(rng, h, w)
    want, want_map = reference.compute_ssim(
        a, b, with_map=True, sigma=2.0, k1=0.02, k2=0.05
    )
    got, got_map = compute_ssim(
        a, b, with_map=True, impl="pallas", sigma=2.0, k1=0.02, k2=0.05
    )
    assert got == pytest.approx(want, abs=2e-6)
    np.testing.assert_allclose(got_map, want_map, atol=1e-3)


def test_default_kwargs_are_identity(rng):
    a, b = random_pair(rng, 31, 45)
    assert compute_ssim(a, b) == compute_ssim(
        a, b, radius=5, sigma=1.5, k1=0.01, k2=0.03
    )


def test_precise_custom_radius_stays_df32(rng, interpret_kernel):
    """precision='f64' + custom radius runs the device f64 tier (any
    radius)."""
    a, b = random_pair(rng, 20, 24)
    want, _ = reference.compute_ssim(a, b, radius=3)
    got = compute_ssim(a, b, impl="pallas", precision="f64", radius=3)
    assert got == pytest.approx(want, abs=1e-8)


def test_precise_oversized_radius_uses_oracle(rng):
    a, b = random_pair(rng, 20, 24)
    want, _ = reference.compute_ssim(a, b, radius=17, sigma=5.0)
    got = compute_ssim(a, b, precision="f64", radius=17, sigma=5.0)
    assert got == pytest.approx(want, abs=1e-13)


def test_precise_float_input_stays_df32(rng, interpret_kernel):
    """precision='f64' with float32 inputs runs the device f64 tier —
    far beyond plain f32."""
    a8, b8 = random_pair(rng, 40, 48)
    a = a8.astype(np.float32) / 255.0
    b = b8.astype(np.float32) / 255.0
    want, _ = reference.compute_ssim(a, b, data_range=1.0)
    got = compute_ssim(a, b, impl="pallas", precision="f64", data_range=1.0)
    assert got == pytest.approx(want, abs=1e-8)


def test_precise_f64_input_keeps_oracle(rng, interpret_kernel):
    """f64 inputs keep every bit on the device f64 tier (no f32 cast)."""
    a8, b8 = random_pair(rng, 24, 24)
    a = a8.astype(np.float64) / 255.0
    b = b8.astype(np.float64) / 255.0
    want, _ = reference.compute_ssim(a, b, data_range=1.0)
    got = compute_ssim(a, b, impl="pallas", precision="f64", data_range=1.0)
    assert got == pytest.approx(want, abs=1e-13)


def test_precise_downsample_stays_df32(rng, interpret_kernel):
    """precision='f64' + downsample: pooled images are device f32 and
    ride the device f64 tier."""
    a, b = random_pair(rng, 64, 64)
    from ssim_tpu.engine import box_decimate

    want, _ = reference.compute_ssim(
        box_decimate(a, 2), box_decimate(b, 2)
    )
    got = compute_ssim(a, b, impl="pallas", precision="f64", downsample=2)
    assert got == pytest.approx(want, abs=1e-8)


def test_precise_downsample_non_pow2(rng, interpret_kernel):
    """downsample=3 divides by 9 — inexact in f32, so the device-pooled
    pixels round ONCE before the f64 arithmetic (engine.compute
    docstring). The result is not exact vs the host f64-pooled oracle,
    but must stay far inside the reference double build's 5e-7 tier."""
    a, b = random_pair(rng, 66, 66)
    from ssim_tpu.engine import box_decimate

    want, _ = reference.compute_ssim(
        box_decimate(a, 3), box_decimate(b, 3)
    )
    got = compute_ssim(a, b, impl="pallas", precision="f64", downsample=3)
    assert got == pytest.approx(want, abs=3e-7)


def test_precise_custom_sigma_stays_df32(rng, interpret_kernel):
    """precision='f64' with custom sigma/k1/k2 runs the device f64 tier
    and lands far inside the double build's error tier."""
    a, b = random_pair(rng, 40, 48)
    want, _ = reference.compute_ssim(a, b, sigma=2.0, k1=0.02, k2=0.05)
    got = compute_ssim(
        a, b, impl="pallas", precision="f64", sigma=2.0, k1=0.02, k2=0.05
    )
    assert got == pytest.approx(want, abs=1e-8)


def test_downsample_composes_with_custom_window(rng):
    """The Wang prefilter pools first, then the custom window applies to
    the pooled image."""
    a, b = random_pair(rng, 64, 64)
    from ssim_tpu.engine import box_decimate

    want, _ = reference.compute_ssim(
        box_decimate(a, 2), box_decimate(b, 2), sigma=2.0
    )
    got = compute_ssim(a, b, downsample=2, sigma=2.0)
    assert got == pytest.approx(want, abs=2e-6)


def test_channels_custom_window(rng):
    from ssim_tpu.multichannel import compute_ssim_channels

    a = np.stack([random_pair(rng, 24, 28)[0] for _ in range(3)], axis=-1)
    b = np.clip(a.astype(np.int32) + 5, 0, 255).astype(np.uint8)
    res = compute_ssim_channels(a, b, sigma=2.0, k1=0.02)
    want = np.mean(
        [
            reference.compute_ssim(a[..., c], b[..., c], sigma=2.0, k1=0.02)[0]
            for c in range(3)
        ]
    )
    assert res.average == pytest.approx(want, abs=2e-6)


def test_host_rejects_custom_window(rng):
    from ssim_tpu.ops import host

    if not host.is_available():
        pytest.skip("native backend unavailable")
    a, b = random_pair(rng, 24, 24)
    with pytest.raises(InvalidArgumentError):
        compute_ssim(a, b, impl="host", sigma=2.0)


@pytest.mark.parametrize(
    "kw",
    [
        dict(radius=0),
        dict(radius=2.5),
        dict(radius=True),
        dict(sigma=0.0),
        dict(sigma=-1.0),
        dict(sigma=float("nan")),
        dict(k1=0.0),
        dict(k2=-0.03),
    ],
)
def test_invalid_window_params_raise(rng, kw):
    a, b = random_pair(rng, 16, 16)
    with pytest.raises(InvalidArgumentError):
        compute_ssim(a, b, **kw)
    import jax.numpy as jnp

    with pytest.raises(InvalidArgumentError):
        ssim(jnp.asarray(a), jnp.asarray(b), **kw)


def test_tiny_k1_k2_degenerate_raises_every_path(rng):
    """k1/k2 that push c1*c2 below normal f32 raise on EVERY route (the
    floor is enforced once in validate_window(data_range), plus defense-
    in-depth guards inside the fused kernels)."""
    import jax.numpy as jnp

    from ssim_tpu.models.msssim import ms_ssim

    a, b = random_pair(rng, 16, 16)
    for impl in ("pallas", "xla"):
        with pytest.raises(ValueError):
            compute_ssim(a, b, impl=impl, k1=1e-18, k2=1e-18)
    with pytest.raises(InvalidArgumentError):
        ssim(jnp.asarray(a), jnp.asarray(b), k1=1e-18, k2=1e-18)
    a176 = np.tile(a, (11, 11))  # big enough for 5 scales
    with pytest.raises(InvalidArgumentError):
        ms_ssim(jnp.asarray(a176), jnp.asarray(a176), k1=1e-18, k2=1e-18)


def test_sigma_validated_on_spatial_layers(rng):
    """The spatial layers validate window params like their batch
    siblings (review finding: NaN taps would otherwise flow silently)."""
    import jax

    from ssim_tpu.parallel import make_mesh, mean_ssim_spatial, ssim_spatial_sharded

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = make_mesh((2,), ("space",))
    a, b = random_pair(rng, 40, 32)
    with pytest.raises(InvalidArgumentError):
        ssim_spatial_sharded(a, b, mesh, sigma=0.0)
    with pytest.raises(InvalidArgumentError):
        mean_ssim_spatial(a, b, mesh, sigma=float("nan"))


def test_non_numeric_window_params_raise_invalid_argument(rng):
    """Non-numeric sigma/k1/k2 surface as InvalidArgumentError, not a
    bare TypeError; bool is rejected like it is for radius."""
    a, b = random_pair(rng, 16, 16)
    for kw in (dict(sigma=[1.5]), dict(sigma="wide"), dict(k1=True),
               dict(k2=None)):
        with pytest.raises(InvalidArgumentError):
            compute_ssim(a, b, **kw)


def test_jittable_matches_eager_custom_window(rng):
    import jax.numpy as jnp

    a, b = random_pair(rng, 40, 48)
    want = compute_ssim(a, b, sigma=2.0, k1=0.02, k2=0.05)
    got = float(ssim(jnp.asarray(a), jnp.asarray(b), sigma=2.0, k1=0.02, k2=0.05))
    assert got == pytest.approx(want, abs=2e-6)
    got_r = float(ssim(jnp.asarray(a), jnp.asarray(b), radius=3))
    want_r = compute_ssim(a, b, radius=3)
    assert got_r == pytest.approx(want_r, abs=2e-6)


def test_fused_backward_custom_sigma_k_matches_xla_vjp(rng, interpret_kernel):
    """jax.grad of ssim_loss with custom sigma/k1/k2 on the kernel path
    (its XLA-formulation VJP carries the custom window) vs the XLA
    formulation's autodiff."""
    import jax
    import jax.numpy as jnp

    a8, b8 = random_pair(rng, 24, 40)
    a = jnp.asarray(a8, jnp.float32) / 255.0
    b = jnp.asarray(b8, jnp.float32) / 255.0

    kw = dict(data_range=1.0, sigma=2.0, k1=0.02, k2=0.05)
    gp_a, gp_b = jax.grad(
        lambda x, y: ssim_loss(x, y, impl="pallas", **kw), argnums=(0, 1)
    )(a, b)
    gx_a, gx_b = jax.grad(
        lambda x, y: ssim_loss(x, y, impl="xla", **kw), argnums=(0, 1)
    )(a, b)
    np.testing.assert_allclose(np.asarray(gp_a), np.asarray(gx_a), atol=2e-5)
    np.testing.assert_allclose(np.asarray(gp_b), np.asarray(gx_b), atol=2e-5)


def test_map_cotangent_custom_window(rng, interpret_kernel):
    """ssim_and_map's per-pixel map cotangent routes through the kernel
    path's VJP with the custom window too."""
    import jax
    import jax.numpy as jnp

    a8, b8 = random_pair(rng, 20, 28)
    a = jnp.asarray(a8, jnp.float32)
    b = jnp.asarray(b8, jnp.float32)
    kw = dict(sigma=1.8, k2=0.04)

    def loss(impl):
        def f(x):
            s, m = ssim_and_map(x, b, impl=impl, **kw)
            return s + jnp.sum(m * m)

        return f

    gp = jax.grad(loss("pallas"))(a)
    gx = jax.grad(loss("xla"))(a)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=2e-4)


def test_custom_radius_grad_via_xla(rng):
    """Non-default radius: ordinary autodiff through the XLA formulation
    still yields gradients (finite-difference spot check)."""
    import jax
    import jax.numpy as jnp

    a8, b8 = random_pair(rng, 16, 18)
    a = jnp.asarray(a8, jnp.float32)
    b = jnp.asarray(b8, jnp.float32)
    f = lambda x: ssim_loss(x, b, data_range=255.0, radius=2)
    g = np.asarray(jax.grad(f)(a))
    eps = 0.1
    y, x = 7, 9
    ap = np.asarray(a).copy()
    ap[y, x] += eps
    am = np.asarray(a).copy()
    am[y, x] -= eps
    fd = (float(f(jnp.asarray(ap))) - float(f(jnp.asarray(am)))) / (2 * eps)
    assert g[y, x] == pytest.approx(fd, rel=2e-2, abs=1e-6)


def test_ms_ssim_custom_sigma_k(rng, interpret_kernel):
    """MS-SSIM sigma/k1/k2 (torchmetrics-style) under impl="pallas"
    match the XLA pyramid, value and gradient, and change the score."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.models.msssim import ms_ssim

    a8, b8 = random_pair(rng, 192, 256)
    kw = dict(sigma=2.0, k1=0.02, k2=0.05)
    got = float(ms_ssim(jnp.asarray(a8), jnp.asarray(b8), impl="pallas", **kw))
    want = float(ms_ssim(jnp.asarray(a8), jnp.asarray(b8), impl="xla", **kw))
    assert got == pytest.approx(want, abs=3e-5)
    # Custom constants must actually change the score.
    base = float(ms_ssim(jnp.asarray(a8), jnp.asarray(b8), impl="xla"))
    assert abs(want - base) > 1e-4

    af = jnp.asarray(a8, jnp.float32)
    bf = jnp.asarray(b8, jnp.float32)
    gp = jax.grad(lambda x: ms_ssim(x, bf, impl="pallas", **kw))(af)
    gx = jax.grad(lambda x: ms_ssim(x, bf, impl="xla", **kw))(af)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=5e-5)


def test_pallas_chunked_path_custom_sigma(rng, interpret_kernel):
    """Custom sigma/k1/k2 on a wide image spanning many column tiles."""
    a, b = random_pair(rng, 8, 1100)
    want, _ = reference.compute_ssim(a, b, sigma=2.0, k1=0.02, k2=0.05)
    got = compute_ssim(a, b, impl="pallas", sigma=2.0, k1=0.02, k2=0.05)
    assert got == pytest.approx(want, abs=2e-6)


def test_packed_path_custom_sigma_k(rng, interpret_kernel):
    """Custom sigma/k1/k2 on a small-image batch through the kernel
    directly and through the auto route."""
    import jax.numpy as jnp

    from ssim_tpu import engine
    from ssim_tpu.ops.ssim_pallas import ssim_parts_pallas

    a = np.stack([random_pair(rng, 64, 64)[0] for _ in range(4)])
    b = np.clip(a.astype(np.int32) + 7, 0, 255).astype(np.uint8)
    kw = dict(sigma=2.0, k1=0.02, k2=0.05)
    parts, _ = ssim_parts_pallas(jnp.asarray(a), jnp.asarray(b), **kw)
    got = engine.finalize_mean(np.asarray(parts), 64 * 64)
    got_auto = compute_ssim(a, b, **kw)
    for i in range(4):
        want, _ = reference.compute_ssim(a[i], b[i], **kw)
        assert got[i] == pytest.approx(want, abs=2e-6)
        assert got_auto[i] == pytest.approx(want, abs=2e-6)
