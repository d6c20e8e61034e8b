"""Differential tests: the fused GPU kernel (ops/ssim_pallas.py) vs the
f64 oracle and the XLA formulation.

On the CPU the kernel runs in the Pallas interpreter (interpret=True,
passed to the kernel directly or through the `interpret_kernel` fixture,
which also makes impl="pallas" available to the engine and the jittable
APIs). The compiled kernel is exercised on the card by chip_smoke.py and
by the tests marked `gpu` at the end of this file.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from ssim_tpu import compute_ssim, engine, reference
from ssim_tpu.ops.ssim_pallas import TILE_H, TILE_W, ssim_parts_pallas
from ssim_tpu.testing import frozen
from ssim_tpu.utils import load_image

from conftest import random_pair


def _parts(a, b, **kw):
    kw.setdefault("interpret", True)
    return ssim_parts_pallas(jnp.asarray(a), jnp.asarray(b), **kw)


def _check(a, b, data_range=255.0, **window):
    """Kernel score and map against the oracle at the f32 tiers."""
    want, want_map = reference.compute_ssim(
        a, b, with_map=True, data_range=data_range, **window)
    p, m = _parts(a, b, with_map=True, data_range=data_range, **window)
    npix = a.shape[-1] * a.shape[-2]
    got = engine.finalize_mean(np.asarray(p), npix)
    tol = max(frozen.GLOBAL_TOLERANCE_F32, 2e-3 / npix**0.5)
    assert np.abs(got - want).max() < tol, (got, want, tol)
    assert m.shape == want_map.shape
    assert np.abs(np.asarray(m) - want_map).max() < frozen.PIXEL_TOLERANCE_F32


# Partial row and column tiles on both sides of the 64 x 128 tile, exact
# tiles, single pixels, tall and wide strips.
@pytest.mark.parametrize(
    "shape",
    [(1, 1), (9, 13), (63, 255), (65, 257), (255, 63), (257, 65),
     (112, 128), (113, 129), (200, 300), (64, 128), (1, 300), (300, 1)],
)
def test_odd_shapes_vs_oracle(rng, shape):
    a, b = random_pair(rng, *shape)
    _check(a, b)


@pytest.mark.parametrize("shape", [(2, 40, 72), (3, 17, 31), (2, 2, 9, 13)])
def test_batched_shapes_vs_oracle(rng, shape):
    """Leading batch dims (one program row per image) keep their shape
    in the partials and the map."""
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)
    p, m = _parts(a, b, with_map=True)
    assert p.shape[:-1] == shape[:-2] and m.shape == shape
    want, want_map = reference.compute_ssim(
        a.reshape((-1,) + shape[-2:]), b.reshape((-1,) + shape[-2:]),
        with_map=True)
    got = engine.finalize_mean(np.asarray(p), shape[-1] * shape[-2])
    np.testing.assert_allclose(got.reshape(-1), want, atol=2e-6)
    np.testing.assert_allclose(np.asarray(m).reshape(want_map.shape),
                               want_map, atol=1e-5)


def test_partials_layout(rng):
    """One f32 partial per (row tile, column tile) program."""
    a, b = random_pair(rng, 2 * TILE_H + 1, TILE_W + 1)
    p, m = _parts(a, b)
    assert m is None
    assert p.dtype == jnp.float32 and p.shape == (3 * 2,)


def test_einstein_vs_oracle(images_dir):
    ref = load_image(os.path.join(images_dir, "einstein.png"))
    img = load_image(os.path.join(images_dir, "blur.png"))
    _check(img, ref)


def test_einstein_frozen_global(images_dir, interpret_kernel):
    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name, want in frozen.EINSTEIN_SUITE.items():
        img = load_image(os.path.join(images_dir, name))
        got = compute_ssim(img, ref, impl="pallas")
        assert abs(got - want) < frozen.GLOBAL_TOLERANCE_F32, (name, got, want)


def test_batched_matches_single(rng, interpret_kernel):
    pairs = [random_pair(rng, 60, 90) for _ in range(2)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    scores = compute_ssim(a, b, impl="pallas")
    for i in range(2):
        single = compute_ssim(a[i], b[i], impl="pallas")
        assert scores[i] == pytest.approx(single, abs=1e-7)


def test_pallas_matches_xla(rng, interpret_kernel):
    """The kernel and the XLA formulation agree to f32 roundoff."""
    a, b = random_pair(rng, 150, 220)
    gx, mx = compute_ssim(a, b, with_map=True, impl="xla")
    gp, mp = compute_ssim(a, b, with_map=True, impl="pallas")
    assert gp == pytest.approx(gx, abs=5e-7)
    assert np.abs(mp - mx).max() < 5e-4


def test_map_on_nonmultiple_width(rng):
    """w not a multiple of the tile width: masked stores in the last
    column tile."""
    a, b = random_pair(rng, 70, 300)
    _check(a, b)


def test_4k_geometry(rng):
    """4K width (30 column tiles) at a reduced height for CI speed."""
    a, b = random_pair(rng, 16, 3840)
    _check(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_geometry(seed):
    """Randomized geometry: kernel vs oracle on random sizes (odd dims,
    tiny and tall shapes)."""
    r = np.random.default_rng(1000 + seed)
    h = int(r.integers(1, 200))
    w = int(r.integers(1, 700))
    a = r.integers(0, 256, (h, w), dtype=np.uint8)
    noise = r.normal(0, 15, a.shape).astype(np.int32)
    b = np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    _check(a, b)


@pytest.mark.parametrize(
    "dtype,data_range",
    [(np.float32, 1.0), (np.float16, 1.0), (jnp.bfloat16, 1.0),
     (np.uint16, 65535.0), (np.float32, 255.0)],
)
def test_float_input_fast_path_matches_oracle(rng, dtype, data_range):
    """Every dtype the routing sends to the kernel is loaded natively and
    converted to f32 in registers."""
    a8, b8 = random_pair(rng, 37, 150)
    scale = data_range / 255.0
    a = (a8 * scale).astype(dtype)
    b = (b8 * scale).astype(dtype)
    want, want_map = reference.compute_ssim(
        np.asarray(a, np.float64), np.asarray(b, np.float64),
        with_map=True, data_range=data_range)
    p, m = _parts(a, b, with_map=True, data_range=data_range)
    got = float(np.asarray(p, np.float64).sum() / a.size)
    assert abs(got - want) < 2e-6
    assert np.abs(np.asarray(m) - want_map).max() < 1e-5


def test_float_negative_values_preserved(rng):
    """Negative float pixels are data, not garbage."""
    a = (rng.random((40, 64)).astype(np.float32) - 0.3) * 2.0
    b = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    p, _ = _parts(a, b, data_range=2.0)
    want, _ = reference.compute_ssim(a, b, data_range=2.0)
    got = float(np.asarray(p, np.float64).sum() / a.size)
    assert abs(got - want) < 1e-6


def test_engine_routes_float_and_u16_to_pallas(rng, interpret_kernel,
                                               monkeypatch):
    """engine.compute on impl='pallas' sends u8, u16 and float pairs to
    the kernel and mixed pairs to XLA."""
    import ssim_tpu.ops.ssim_pallas as kernel

    calls = []
    real = kernel.ssim_parts_pallas
    monkeypatch.setattr(kernel, "ssim_parts_pallas",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    a8, b8 = random_pair(rng, 20, 30)
    for a, b, dr in ((a8, b8, 255.0),
                     (a8.astype(np.uint16), b8.astype(np.uint16), 255.0),
                     (a8 / 255.0, b8 / 255.0, 1.0)):
        n = len(calls)
        got = compute_ssim(a, b, impl="pallas", data_range=dr)
        assert len(calls) == n + 1
        want, _ = reference.compute_ssim(a, b, data_range=dr)
        assert got == pytest.approx(want, abs=2e-6)
    n = len(calls)
    compute_ssim(a8, b8.astype(np.float32), impl="pallas")
    assert len(calls) == n


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_float_and_precise_paths(seed):
    """Randomized float geometry and data range against the oracle."""
    r = np.random.default_rng(2000 + seed)
    h = int(r.integers(1, 120))
    w = int(r.integers(1, 400))
    dr = float(r.choice([1.0, 255.0, 1e4]))
    a = (r.random((h, w)) * dr).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.05 * dr, a.shape), 0, dr).astype(np.float32)
    _check(a, b, data_range=dr)


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (2, 1.0), (7, 2.5),
                                          (11, 3.0), (16, 4.0)])
def test_custom_radius_vs_oracle(rng, radius, sigma):
    """The register ring holds 2r+1 rows for any radius up to
    MAX_FUSED_RADIUS, including radii larger than small images."""
    a, b = random_pair(rng, 30, 140)
    _check(a, b, radius=radius, sigma=sigma)


@pytest.mark.parametrize("sigma,k1,k2", [(2.0, 0.02, 0.05), (0.7, 0.01, 0.03),
                                         (1.5, 0.05, 0.01)])
def test_custom_sigma_k1_k2_vs_oracle(rng, sigma, k1, k2):
    a, b = random_pair(rng, 45, 90)
    _check(a, b, sigma=sigma, k1=k1, k2=k2)


@pytest.mark.parametrize("h,w,r,hs", [
    (40, 72, 5, 30),     # band of one row tile
    (150, 140, 5, 140),  # owned rows span three row tiles
    (38, 200, 3, 32),    # narrower halo
    (36, 90, 16, 4),     # owned rows thinner than the halo
])
def test_band_rows_match_full_image(rng, h, w, r, hs):
    """row_offset/out_h (the spatial-sharding band mode): the owned rows
    of a band that carries r real halo rows above and below equal those
    rows of the full-image map."""
    assert h >= hs + 2 * r
    a, b = random_pair(rng, h, w)
    _, full = _parts(a, b, with_map=True, radius=r)
    top = (h - hs) // 2 - r
    band = slice(top, top + hs + 2 * r)
    p, m = _parts(a[band], b[band], with_map=True, radius=r, row_offset=r,
                  out_h=hs)
    want = np.asarray(full)[top + r: top + r + hs]
    assert m.shape == (hs, w)
    np.testing.assert_allclose(np.asarray(m), want, atol=1e-6)
    assert float(np.asarray(p, np.float64).sum()) == pytest.approx(
        float(want.astype(np.float64).sum()), abs=1e-3)


@pytest.mark.parametrize("with_map", [False, True])
@pytest.mark.parametrize("shape", [(64, 129), (65, 128), (2, 70, 250),
                                   (130, 20), (5, 400), (3, 3, 3)])
def test_kernel_matches_xla_parts(rng, shape, with_map):
    """Kernel and XLA formulation agree on the score per image and on
    the map, with and without the map output, over tile-edge geometries
    and batches."""
    from ssim_tpu.ops.ssim_xla import ssim_parts_xla

    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)
    pk, mk = _parts(a, b, with_map=with_map)
    px, mx = ssim_parts_xla(a, b, with_map=with_map)
    npix = shape[-1] * shape[-2]
    np.testing.assert_allclose(engine.finalize_mean(np.asarray(pk), npix),
                               engine.finalize_mean(np.asarray(px), npix),
                               atol=5e-7)
    if with_map:
        np.testing.assert_allclose(np.asarray(mk), np.asarray(mx), atol=5e-5)
    else:
        assert mk is None and mx is None


def test_adaptive_tile_taller_than_image(rng):
    """Images shorter than one row tile and narrower than one column
    tile: a single program whose halo rows are all clamped."""
    a, b = random_pair(rng, 3, 5)
    _check(a, b)


def test_kernel_validates_inputs():
    """Shape and dtype mismatches are refused before tracing the kernel."""
    with pytest.raises(ValueError, match="dtype"):
        _parts(np.zeros((8, 8), np.uint8), np.zeros((8, 9), np.uint8))
    with pytest.raises(ValueError, match="dtype"):
        _parts(np.zeros((8, 8), np.int32), np.zeros((8, 8), np.int32))


# Compiled on the card (JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
# -p no:xdist); skipped elsewhere.

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (63, 255), (257, 65), (3, 200, 300)])
def test_compiled_kernel_vs_oracle(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)
    want, want_map = reference.compute_ssim(
        a.reshape((-1,) + shape[-2:]), b.reshape((-1,) + shape[-2:]),
        with_map=True)
    p, m = _parts(a, b, with_map=True, interpret=False)
    got = engine.finalize_mean(np.asarray(p), shape[-1] * shape[-2])
    np.testing.assert_allclose(got.reshape(-1), want, atol=2e-6)
    np.testing.assert_allclose(np.asarray(m).reshape(want_map.shape),
                               want_map, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [1, 16])
def test_compiled_kernel_radius_and_float(rng, radius):
    a8, b8 = random_pair(rng, 70, 150)
    a, b = a8 / np.float32(255), b8 / np.float32(255)
    want, _ = reference.compute_ssim(a, b, data_range=1.0, radius=radius)
    p, _ = _parts(a.astype(np.float32), b.astype(np.float32),
                  data_range=1.0, radius=radius, interpret=False)
    assert float(np.asarray(p, np.float64).sum() / a.size) == pytest.approx(
        want, abs=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,data_range",
    [(np.uint16, 65535.0), (np.float16, 1.0), (jnp.bfloat16, 1.0)],
)
def test_compiled_kernel_native_dtypes(rng, dtype, data_range):
    """The dtypes the routing sends to the kernel besides u8 and f32,
    loaded natively by the compiled kernel."""
    a8, b8 = random_pair(rng, 90, 200)
    scale = data_range / 255.0
    a, b = (a8 * scale).astype(dtype), (b8 * scale).astype(dtype)
    want, _ = reference.compute_ssim(np.asarray(a, np.float64),
                                     np.asarray(b, np.float64),
                                     data_range=data_range)
    p, _ = _parts(a, b, data_range=data_range, interpret=False)
    assert float(np.asarray(p, np.float64).sum() / a.size) == pytest.approx(
        want, abs=2e-6)


@pytest.mark.gpu
def test_auto_picks_kernel_on_gpu():
    from ssim_tpu.dispatch import Implementation, select_impl

    assert select_impl("auto") == Implementation.PALLAS
