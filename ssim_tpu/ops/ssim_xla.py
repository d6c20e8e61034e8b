"""Pure-XLA SSIM path (jnp; no Pallas), for every platform.

The plain formulation of the reference's generic + SIMD kernel stack
(multiply src/ssim.cpp:249-265, gaussian_blur :321-489, sum_tile
:590-704): one traced function XLA fuses and tiles itself. It is the
path on the CPU, the reference the fused GPU kernel (ops/ssim_pallas.py)
is checked against, the gradient of every training call, and the f64
tier (dtype=float64).

Design notes:
- The reference's scatter-style radius-5 blur (one source row scatter-added
  into 11 destination rows, src/ssim.cpp:451-462) is re-expressed as a
  gather-style *separable* pair of 1-D passes using static shifted slices —
  each tap is an elementwise FMA over the whole array, and XLA fuses the
  11-tap chain. Symmetric taps are paired (add-then-scale) like the
  reference's L/R symmetry factorization (src/ssim.cpp:366-449): 6 muls +
  10 adds per pass. There is no matrix product, so TF32 never applies.
- Each of the five windowed signals (a, b, a*a, b*b, a*b) is blurred
  separately, each multiply+row-pass its own fusion.
- Per-pixel math is f32 (parity with the reference's default Float,
  src/ssim_internal.h:26-37). The global accumulation is hierarchical:
  row sums here (pairwise-safe), f64 finalize on the host in the engine —
  matching the reference's double accumulation guarantee
  (src/ssim.cpp:594).
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..windows import RADIUS, SIGMA, gaussian_taps


def _pad_edge(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Clamp-to-edge padding of the last two dims (reference border rule,
    src/ssim.cpp:497-583)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (radius, radius)]
    return jnp.pad(x, pad, mode="edge")


def blur_separable(x: jnp.ndarray, taps: np.ndarray, radius: int = RADIUS) -> jnp.ndarray:
    """Separable Gaussian blur over the last two dims of an edge-padded
    array. Input (..., H+2r, W+2r) -> output (..., H, W)."""
    h = x.shape[-2] - 2 * radius
    w = x.shape[-1] - 2 * radius
    center = int(radius)
    # Smallest taps accumulate first to minimize f32 rounding; the
    # symmetric pair sum (lo + hi) is exact for u8-derived signals.
    # Row pass: (..., H+2r, W+2r) -> (..., H+2r, W)
    acc = None
    for d in range(radius, 0, -1):
        lo = jax.lax.slice_in_dim(x, center - d, center - d + w, axis=-1)
        hi = jax.lax.slice_in_dim(x, center + d, center + d + w, axis=-1)
        term = taps[center - d] * (lo + hi)
        acc = term if acc is None else acc + term
    acc = acc + taps[center] * jax.lax.slice_in_dim(x, center, center + w, axis=-1)
    # Column pass: (..., H+2r, W) -> (..., H, W)
    out = None
    for d in range(radius, 0, -1):
        lo = jax.lax.slice_in_dim(acc, center - d, center - d + h, axis=-2)
        hi = jax.lax.slice_in_dim(acc, center + d, center + d + h, axis=-2)
        term = taps[center - d] * (lo + hi)
        out = term if out is None else out + term
    return out + taps[center] * jax.lax.slice_in_dim(acc, center, center + h, axis=-2)


def ssim_from_padded(
    ap: jnp.ndarray,
    bp: jnp.ndarray,
    *,
    with_map: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    data_range: float = 255.0,
    dtype: jnp.dtype = jnp.float32,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """SSIM core over already edge-padded float inputs (..., H+2r, W+2r).

    Exposed separately so the spatial-sharding path (parallel/spatial.py)
    can substitute neighbor-halo rows for edge padding. Returns
    (row_sums (..., H) f32, map (..., H, W) or None).
    """
    taps = gaussian_taps(np.dtype(dtype), radius, sigma)
    c1 = dtype((k1 * data_range) ** 2)
    c2 = dtype((k2 * data_range) ** 2)

    # Five separate blurs, one per windowed signal: a stacked blur would
    # materialize a 5x-sized intermediate between the row and column
    # passes.
    mu_a = blur_separable(ap, taps, radius)
    mu_b = blur_separable(bp, taps, radius)
    s_a2 = blur_separable(ap * ap, taps, radius)
    s_b2 = blur_separable(bp * bp, taps, radius)
    s_ab = blur_separable(ap * bp, taps, radius)

    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_a2 = s_a2 - mu_a2
    sigma_b2 = s_b2 - mu_b2
    sigma_ab = s_ab - mu_ab

    num = (2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    ssim_map = num / den

    # Row sums in the compute dtype, at least f32: the f64 tier keeps
    # its precision through the reduction.
    row_sums = jnp.sum(ssim_map, axis=-1,
                       dtype=jnp.promote_types(dtype, jnp.float32))
    return row_sums, (ssim_map if with_map else None)


@functools.partial(
    jax.jit,
    static_argnames=(
        "with_map", "radius", "sigma", "data_range", "dtype", "k1", "k2",
    ),
)
def ssim_parts_xla(
    a: jnp.ndarray,
    b: jnp.ndarray,
    *,
    with_map: bool = False,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    data_range: float = 255.0,
    dtype: jnp.dtype = jnp.float32,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Core jittable SSIM computation.

    a, b: (..., H, W), any integer or float dtype (uint8 is the parity
    input, src/ssim.cpp:515). Returns (row_sums, ssim_map or None) where
    row_sums has shape (..., H): per-row f32 sums of the per-pixel SSIM,
    for exact-enough hierarchical reduction by the caller.
    """
    a = a.astype(dtype)
    b = b.astype(dtype)
    ap = _pad_edge(a, radius)
    bp = _pad_edge(b, radius)
    return ssim_from_padded(
        ap, bp, with_map=with_map, radius=radius, sigma=sigma,
        data_range=data_range, dtype=dtype, k1=k1, k2=k2,
    )
