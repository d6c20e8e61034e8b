"""Gradient tests for the training surface (ssim, ssim_and_map, ssim_loss,
ms_ssim).

Every gradient is autodiff through the XLA formulation. On the fused
kernel's route (impl="pallas", the GPU default; here the Pallas
interpreter through the `interpret_kernel` fixture) the kernel is the
primal and ops.routing.with_xla_vjp supplies the XLA formulation's VJP.
The checks: kernel route against the XLA route, f32 against f64 autodiff,
and f64 finite differences of the NumPy oracle as independent ground
truth — across geometries that exercise every border-fold case.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import random_pair
from ssim_tpu import ms_ssim, ssim, ssim_and_map, ssim_loss
from ssim_tpu.ops.ssim_xla import ssim_parts_xla


def _float_pair(rng, h, w, batch=None):
    shape = (h, w) if batch is None else (batch, h, w)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, shape), 0, 1).astype(np.float32)
    return a, b


def _grad(fn, a, b):
    return jax.grad(lambda x, y: jnp.sum(fn(x, y)), argnums=(0, 1))(a, b)


# Geometries covering: aligned, odd/ragged both dims, single-tile,
# multi-tile rows and columns, tiny (every pixel is an edge fold).
GEOMETRIES = [
    (48, 64), (33, 47), (97, 128), (20, 256), (8, 8), (128, 96), (7, 11),
    (64, 640), (40, 517),
]


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_grad_matches_xla_vjp(rng, h, w, interpret_kernel):
    """The kernel route's gradient is the XLA formulation's."""
    a, b = _float_pair(rng, h, w)
    gp = _grad(lambda x, y: ssim(x, y, data_range=1.0, impl="pallas"), a, b)
    gx = _grad(lambda x, y: ssim(x, y, data_range=1.0, impl="xla"), a, b)
    for p, x in zip(gp, gx):
        np.testing.assert_allclose(np.asarray(p), np.asarray(x), atol=1e-7)


@pytest.mark.parametrize("h,w", [(48, 64), (33, 47), (7, 11), (40, 517)])
def test_grad_matches_f64_autodiff(rng, h, w):
    """f32 autodiff against the same formulation differentiated in f64:
    the bound chip_smoke applies on the card, 3e-5 of max |g|."""
    a, b = _float_pair(rng, h, w)
    g = np.asarray(jax.grad(lambda x: ssim_loss(x, b))(a))
    with jax.enable_x64(True):
        g64 = np.asarray(jax.grad(lambda x: 1.0 - jnp.sum(ssim_parts_xla(
            x, jnp.asarray(b, jnp.float64), data_range=1.0,
            dtype=jnp.float64)[0]) / (h * w))(jnp.asarray(a, jnp.float64)))
    assert np.abs(g - g64).max() <= 3e-5 * np.abs(g64).max()


def test_grad_cs_channel_matches_autodiff(rng):
    """The contrast-structure map MS-SSIM averages differentiates like
    the full SSIM map: both through the same stacked four-signal blur."""
    from ssim_tpu.models.msssim import _l_cs_maps
    from ssim_tpu.windows import RADIUS, SIGMA, gaussian_taps

    a, b = _float_pair(rng, 40, 56)

    def mean_cs(x, dtype):
        taps = gaussian_taps(np.dtype(dtype), RADIUS, SIGMA)
        c1, c2 = np.asarray(0.01 ** 2, dtype), np.asarray(0.03 ** 2, dtype)
        return jnp.mean(_l_cs_maps(x, jnp.asarray(b, dtype), c1, c2, taps)[1])

    g = np.asarray(jax.grad(lambda x: mean_cs(x, np.float32))(jnp.asarray(a)))
    eps = 1e-4
    with jax.enable_x64(True):
        for (y, x) in [(0, 0), (20, 30), (39, 55)]:
            ap, am = a.astype(np.float64), a.astype(np.float64)
            ap[y, x] += eps
            am[y, x] -= eps
            fd = (float(mean_cs(jnp.asarray(ap), np.float64))
                  - float(mean_cs(jnp.asarray(am), np.float64))) / (2 * eps)
            assert g[y, x] == pytest.approx(fd, rel=2e-3, abs=1e-7)


def test_grad_batched_per_image_weights(rng, interpret_kernel):
    """Per-image cotangents of a batched call land on their own images."""
    ab, bb = _float_pair(rng, 24, 40, batch=2)
    ws = jnp.asarray([0.7, -0.3])
    da = jax.grad(lambda x: jnp.sum(
        ws * ssim(x, bb, data_range=1.0, impl="pallas")))(ab)
    for i in range(2):
        di = jax.grad(lambda x: ws[i] * ssim(
            x, bb[i], data_range=1.0, impl="pallas"))(ab[i])
        np.testing.assert_allclose(np.asarray(da[i]), np.asarray(di),
                                   atol=1e-7)


def test_grad_nan_input_poisons_gradients(rng, interpret_kernel):
    a, b = _float_pair(rng, 24, 32)
    a[5, 7] = np.nan
    da, db = _grad(lambda x, y: ssim(x, y, data_range=1.0, impl="pallas"),
                   a, b)
    assert np.isnan(np.asarray(da)).any() and np.isnan(np.asarray(db)).any()


def test_grad_rejects_unsupported(rng, interpret_kernel):
    """u8 inputs have no gradient: jax.grad refuses integer inputs on the
    kernel route like on the XLA route."""
    a8, b8 = random_pair(rng, 16, 16)
    for impl in ("pallas", "xla"):
        with pytest.raises(TypeError):
            jax.grad(lambda x: ssim(x, b8, impl=impl))(a8)


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (3, 1.2), (8, 2.5),
                                          (16, 4.0)])
def test_grad_custom_radius_matches_xla_vjp(rng, radius, sigma,
                                            interpret_kernel):
    a, b = _float_pair(rng, 36, 44)
    kw = dict(data_range=1.0, radius=radius, sigma=sigma)
    gp = _grad(lambda x, y: ssim(x, y, impl="pallas", **kw), a, b)
    gx = _grad(lambda x, y: ssim(x, y, impl="xla", **kw), a, b)
    for p, x in zip(gp, gx):
        np.testing.assert_allclose(np.asarray(p), np.asarray(x), atol=1e-7)


def test_grad_custom_radius_wide_mxu(rng, interpret_kernel):
    """A wide image over several column tiles with a custom window."""
    a, b = _float_pair(rng, 16, 300)
    kw = dict(data_range=1.0, radius=7, sigma=2.0)
    gp = jax.grad(lambda x: ssim_loss(x, b, impl="pallas", **kw))(a)
    gx = jax.grad(lambda x: ssim_loss(x, b, impl="xla", **kw))(a)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=1e-7)


def test_ssim_grad_end_to_end_custom_radius(rng):
    """jax.grad of ssim_loss with a custom radius, on the default route,
    against f64 finite differences of the oracle at one pixel."""
    from ssim_tpu import reference

    a, b = _float_pair(rng, 20, 24)
    g = np.asarray(jax.grad(lambda x: ssim_loss(x, b, radius=3,
                                                sigma=1.2))(a))
    eps = 1e-4
    ap, am = a.astype(np.float64), a.astype(np.float64)
    ap[9, 11] += eps
    am[9, 11] -= eps
    kw = dict(data_range=1.0, radius=3, sigma=1.2)
    sp, _ = reference.compute_ssim(ap, b.astype(np.float64), **kw)
    sm, _ = reference.compute_ssim(am, b.astype(np.float64), **kw)
    assert g[9, 11] == pytest.approx(-(sp - sm) / (2 * eps), rel=2e-3,
                                     abs=1e-6)


def _runs_kernel(fn, *args):
    """Whether the traced program of fn(*args) contains a pallas_call."""
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


def test_ssim_loss_uses_pallas_backward(rng, interpret_kernel):
    """Under jax.grad the kernel route linearizes the XLA formulation:
    the gradient program holds no kernel, the primal-only one does."""
    a, b = _float_pair(rng, 26, 30)
    assert not _runs_kernel(
        jax.grad(lambda x: ssim_loss(x, b, impl="pallas")), a)
    assert _runs_kernel(lambda x: ssim_loss(x, b, impl="pallas"), a)


def test_ms_ssim_grad_pallas_matches_xla(rng, interpret_kernel):
    a, b = _float_pair(rng, 176, 180)
    gp = jax.grad(lambda x: ms_ssim(x, b, data_range=1.0, impl="pallas"))(a)
    gx = jax.grad(lambda x: ms_ssim(x, b, data_range=1.0, impl="xla"))(a)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=1e-7)


def test_ms_ssim_grad_uses_pallas_backward(rng, interpret_kernel):
    """MS-SSIM runs the XLA pyramid on every impl, forward and backward:
    no program holds the kernel."""
    a, b = _float_pair(rng, 176, 184)
    f = lambda x: ms_ssim(x, b, data_range=1.0, impl="pallas")
    assert not _runs_kernel(jax.grad(f), a)
    assert not _runs_kernel(f, a)


def test_grad_f64_finite_difference_spotcheck(rng, interpret_kernel):
    """Independent ground truth: central finite differences of the f64
    oracle at a handful of pixels (catches a systematically-wrong-but-
    self-consistent pair of VJPs)."""
    from ssim_tpu import reference

    h, w = 24, 32
    a, b = _float_pair(rng, h, w)
    da = np.asarray(jax.grad(
        lambda x: ssim(x, b, data_range=1.0, impl="pallas"))(a)) * (h * w)
    eps = 1e-4
    for (y, x) in [(0, 0), (0, 31), (23, 0), (12, 16), (5, 30)]:
        ap = a.astype(np.float64).copy()
        am = ap.copy()
        ap[y, x] += eps
        am[y, x] -= eps
        sp, _ = reference.compute_ssim(ap, b.astype(np.float64), data_range=1.0)
        sm, _ = reference.compute_ssim(am, b.astype(np.float64), data_range=1.0)
        fd = (sp - sm) / (2 * eps) * (h * w)  # oracle returns the MEAN
        assert da[y, x] == pytest.approx(fd, rel=2e-3, abs=1e-5)


@pytest.mark.parametrize("h,w", [(48, 64), (33, 47), (40, 517)])
def test_grad_map_cotangent_matches_xla_vjp(rng, h, w, interpret_kernel):
    """Per-pixel map cotangents (the ssim_and_map backward) on the kernel
    route vs the XLA autodiff VJP."""
    a, b = _float_pair(rng, h, w)
    R = rng.normal(0, 1, (h, w)).astype(np.float32)
    alpha = 0.37

    def loss(impl):
        def f(x, y):
            s, m = ssim_and_map(x, y, data_range=1.0, impl=impl)
            return alpha * s + jnp.sum(R * m)
        return f

    gp = jax.grad(loss("pallas"), argnums=(0, 1))(a, b)
    gx = jax.grad(loss("xla"), argnums=(0, 1))(a, b)
    for p, x in zip(gp, gx):
        np.testing.assert_allclose(np.asarray(p), np.asarray(x), atol=1e-7)


def test_ssim_and_map_grad_uses_pallas_backward(rng, interpret_kernel):
    """ssim_and_map's gradient linearizes the XLA formulation (no kernel
    in its program); its primal keeps the kernel."""
    a, b = _float_pair(rng, 22, 26)
    f = lambda x: jnp.sum(ssim_and_map(x, b, data_range=1.0,
                                       impl="pallas")[1])
    assert not _runs_kernel(jax.grad(f), a)
    assert _runs_kernel(f, a)


def test_grad_map_cotangent_batched(rng, interpret_kernel):
    ab, bb = _float_pair(rng, 20, 28, batch=2)
    R = rng.normal(0, 1, ab.shape).astype(np.float32)
    da = jax.grad(lambda x: jnp.sum(
        R * ssim_and_map(x, bb, data_range=1.0, impl="pallas")[1]))(ab)
    for i in range(2):
        di = jax.grad(lambda x: jnp.sum(
            R[i] * ssim_and_map(x, bb[i], data_range=1.0, impl="pallas")[1]
        ))(ab[i])
        np.testing.assert_allclose(np.asarray(da[i]), np.asarray(di),
                                   atol=1e-7)


def test_grad_tile_h_variants_agree(rng, interpret_kernel):
    """Heights around the kernel's row tile (one short, exact, one over)
    differentiate like the XLA route."""
    from ssim_tpu.ops.ssim_pallas import TILE_H

    for h in (TILE_H - 1, TILE_H, TILE_H + 1):
        a, b = _float_pair(rng, h, 20)
        gp = jax.grad(lambda x: ssim(x, b, data_range=1.0, impl="pallas"))(a)
        gx = jax.grad(lambda x: ssim(x, b, data_range=1.0, impl="xla"))(a)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=1e-7)


def test_grad_relaxed_tier(rng, interpret_kernel):
    """accuracy="relaxed" computes at standard accuracy, gradients
    included."""
    a, b = _float_pair(rng, 30, 40)
    g0 = jax.grad(lambda x: ssim_loss(x, b, impl="pallas"))(a)
    g1 = jax.grad(lambda x: ssim_loss(x, b, impl="pallas",
                                      accuracy="relaxed"))(a)
    np.testing.assert_array_equal(np.asarray(g0), np.asarray(g1))


@pytest.mark.parametrize("data_range", [255.0, 1e4])
def test_grad_data_range_scaling(rng, data_range, interpret_kernel):
    """u8-scale and HDR data ranges (c1/c2 scale quartically)."""
    a = (rng.random((48, 64)) * data_range).astype(np.float32)
    b = np.clip(
        a + rng.normal(0, 0.05 * data_range, a.shape).astype(np.float32),
        0, data_range,
    )
    kw = dict(data_range=data_range)
    gp = _grad(lambda x, y: ssim(x, y, impl="pallas", **kw), a, b)
    gx = _grad(lambda x, y: ssim(x, y, impl="xla", **kw), a, b)
    scale = float(np.abs(np.asarray(gx[0])).max()) + 1e-30
    for p, x in zip(gp, gx):
        np.testing.assert_allclose(np.asarray(p), np.asarray(x),
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", [jnp.float16, jnp.bfloat16])
def test_grad_low_precision_inputs(rng, dtype, interpret_kernel):
    """f16/bf16 inputs ride the kernel route; gradients come back in the
    input dtype, finite."""
    a, b = _float_pair(rng, 24, 30)
    a, b = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    g = jax.grad(lambda x: ssim_loss(x, b, impl="pallas"))(a)
    assert g.dtype == dtype
    assert bool(jnp.isfinite(g.astype(jnp.float32)).all())


def test_grad_wide_column_chunked(rng, interpret_kernel):
    """A width over many of the kernel's column tiles, jitted."""
    a, b = _float_pair(rng, 12, 1100)
    gp = jax.jit(jax.grad(lambda x: ssim_loss(x, b, impl="pallas")))(a)
    gx = jax.grad(lambda x: ssim_loss(x, b, impl="xla"))(a)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), atol=1e-7)
