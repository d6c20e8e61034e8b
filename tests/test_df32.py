"""Double-float (df32) arithmetic of ops/df32.py, the jitted finalize's
building blocks: the error-free transforms must be exact, and the df32
operations f64-grade, against NumPy float64."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssim_tpu.ops import df32


def _f32(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_two_sum_exact(seed):
    r = np.random.default_rng(seed)
    a, b = _f32(r, 1000, 1e3), _f32(r, 1000, 1e-3)
    s, e = jax.jit(df32._two_sum)(a, b)
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(np.asarray(s, np.float64)
                                  + np.asarray(e, np.float64), exact)


@pytest.mark.parametrize("seed", range(4))
def test_two_prod_exact(seed):
    r = np.random.default_rng(100 + seed)
    a, b = _f32(r, 1000, 1e2), _f32(r, 1000, 1e-2)
    p, e = jax.jit(df32._two_prod)(a, b)
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(np.asarray(p, np.float64)
                                  + np.asarray(e, np.float64), exact)


@pytest.mark.parametrize("seed", range(3))
def test_df_div_accuracy(seed):
    """df/df division to a few ulp of df32 (~1e-14 relative)."""
    r = np.random.default_rng(200 + seed)
    x = np.abs(_f32(r, 500, 1e5)) + 1
    y = np.abs(_f32(r, 500, 1e3)) + 1
    q = jax.jit(lambda p, d: df32.df_div((p, jnp.zeros_like(p)),
                                         (d, jnp.zeros_like(d))))(x, y)
    got = np.asarray(q[0], np.float64) + np.asarray(q[1], np.float64)
    want = x.astype(np.float64) / y.astype(np.float64)
    assert np.max(np.abs(got - want) / want) < 1e-13


def test_df_add_accumulates_beyond_f32():
    """Adding many small values to a large one: df32 keeps what plain
    f32 loses."""
    big = jnp.float32(1e6)
    acc = (big, jnp.float32(0))
    small = (jnp.float32(1e-3), jnp.float32(0))
    step = jax.jit(df32.df_add)
    for _ in range(1000):
        acc = step(acc, small)
    got = float(acc[0]) + float(acc[1])
    assert got == pytest.approx(1e6 + 1000 * float(np.float32(1e-3)),
                                abs=1e-6)
    assert float(big + jnp.float32(1e-3)) == 1e6  # plain f32 drops it


def test_df_const_splits_exactly():
    for v in (1920 * 1080, 0.1, 1 / 3, 8294400.0):
        hi, lo = df32.df_const(v)
        assert np.float32(hi) == hi and np.float32(lo) == lo
        assert abs(hi + lo - v) <= abs(v) * 2.0 ** -46
