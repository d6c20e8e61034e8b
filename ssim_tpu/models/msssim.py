"""Multi-scale SSIM (MS-SSIM) — extension.

No reference analogue (rmgr::ssim is single-scale only); implemented to
the standard recipe of Wang, Simoncelli & Bovik, "Multi-scale structural
similarity for image quality assessment" (Asilomar 2003):

- 5 scales, exponents (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
- contrast-structure term cs = (2 sigma_ab + c2) / (sa2 + sb2 + c2)
  averaged at every scale; the luminance term only at the coarsest,
- dyadic downsampling by 2x2 mean pooling between scales.

Window/constants/border semantics are inherited from the core metric
(11x11 sigma=1.5, clamp-to-edge, c1/c2 from data_range) so single-scale
results stay consistent with the reference contract.
"""

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ssim_xla import _pad_edge, blur_separable
from ..windows import RADIUS, SIGMA, gaussian_taps

#: The canonical 5-scale exponents (Wang et al. 2003, table 1).
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _l_cs_maps(a, b, c1, c2, taps):
    """Luminance-term and contrast-structure-term maps of one scale.
    a, b: float (..., H, W)."""
    ap = _pad_edge(a, RADIUS)
    bp = _pad_edge(b, RADIUS)
    s = ap + bp
    d = ap - bp
    sig = jnp.stack([ap, bp, s * s, d * d], axis=0)
    mu_a, mu_b, ss, dd = (x for x in blur_separable(sig, taps, RADIUS))
    mu_a2 = mu_a * mu_a
    mu_b2 = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_ab_x4 = (ss - dd) - 4.0 * mu_ab
    sigma_sum_x2 = (ss + dd) - 2.0 * (mu_a2 + mu_b2)
    l_map = (2.0 * mu_ab + c1) / (mu_a2 + mu_b2 + c1)
    cs_map = (0.5 * sigma_ab_x4 + c2) / (0.5 * sigma_sum_x2 + c2)
    return l_map, cs_map


def _downsample2(x):
    """2x2 mean pooling, truncating odd trailing rows/cols (the standard
    MS-SSIM dyadic pyramid step), as an add reduce_window."""
    dims = (1,) * (x.ndim - 2) + (2, 2)
    zero = np.zeros((), x.dtype)
    s = jax.lax.reduce_window(x, zero, jax.lax.add, dims, dims, "VALID")
    return s * np.asarray(0.25, x.dtype)


def _check_levels(a, levels):
    min_side = min(a.shape[-1], a.shape[-2])
    if min_side < (2 * RADIUS + 1) * 2 ** (levels - 1):
        raise ValueError(
            f"image side {min_side} too small for {levels} scales; "
            f"needs >= {(2 * RADIUS + 1) * 2 ** (levels - 1)} (pass fewer weights)"
        )


def _ms_xla_forward(a, b, data_range, weights, sigma=SIGMA, k1=0.01, k2=0.03,
                    dtype=jnp.float32):
    """The 5-scale pyramid in the XLA formulation (differentiable by
    ordinary autodiff). dtype=float64 (under jax.enable_x64) gives the
    double-precision reference of the same pyramid."""
    levels = len(weights)
    taps = gaussian_taps(np.dtype(dtype), RADIUS, sigma)
    c1 = np.asarray((k1 * data_range) ** 2, dtype)
    c2 = np.asarray((k2 * data_range) ** 2, dtype)

    af = a.astype(dtype)
    bf = b.astype(dtype)
    result = None
    for lvl, w in enumerate(weights):
        l_map, cs_map = _l_cs_maps(af, bf, c1, c2, taps)
        # Negative means are clamped (standard practice: a^w is undefined
        # for a < 0; the eps keeps gradients finite).
        if lvl == levels - 1:
            # Coarsest scale uses the full SSIM mean, i.e. mean(l * cs)
            # (Wang 2003 eq. 7) — not the product of the two means.
            term = jnp.maximum(jnp.mean(l_map * cs_map, axis=(-2, -1)), 1e-6) ** w
        else:
            term = jnp.maximum(jnp.mean(cs_map, axis=(-2, -1)), 1e-6) ** w
            af = _downsample2(af)
            bf = _downsample2(bf)
        result = term if result is None else result * term
    return result


@functools.partial(
    jax.jit,
    static_argnames=(
        "data_range", "weights", "impl", "accuracy", "sigma", "k1", "k2",
    ),
)
def ms_ssim(
    a: jnp.ndarray,
    b: jnp.ndarray,
    *,
    data_range: float = 255.0,
    weights: Tuple[float, ...] = MS_SSIM_WEIGHTS,
    impl: str = "auto",
    accuracy: str = "standard",
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Jittable MS-SSIM. a, b: (..., H, W); needs min(H, W) >= 11 * 2^(L-1).

    Returns scalar for 2-D inputs, (B,) for batched. Differentiable by
    ordinary autodiff through the XLA formulation, which every platform
    runs.

    impl: validated like every entry point ("auto", "xla", ...); every
    resolved impl computes the XLA pyramid.

    accuracy: "standard" or "relaxed"; "relaxed" is accepted for
    compatibility and computes at standard accuracy.

    sigma/k1/k2 (extension, torchmetrics-style): custom window spread and
    stabilization constants, threaded through every scale (radius stays
    5 — the canonical MS-SSIM window size).
    """
    from ..api import _relaxed
    from ..dispatch import select_impl
    from ..engine import validate_pair, validate_window

    _relaxed(accuracy)
    validate_pair(a, b)  # static at trace time (same EINVAL surface as engine.compute)
    validate_window(RADIUS, sigma, k1, k2, data_range)
    _check_levels(a, len(weights))
    select_impl(impl)
    return _ms_xla_forward(a, b, data_range, weights, sigma, k1, k2)


def compute_ms_ssim(a, b, *, data_range: float = 255.0,
                    weights: Sequence[float] = MS_SSIM_WEIGHTS,
                    impl: str = "auto", accuracy: str = "standard",
                    sigma: float = SIGMA, k1: float = 0.01,
                    k2: float = 0.03) -> float:
    """Eager convenience wrapper (host arrays in, float out)."""
    res = ms_ssim(jnp.asarray(np.asarray(a)), jnp.asarray(np.asarray(b)),
                  data_range=data_range, weights=tuple(weights), impl=impl,
                  accuracy=accuracy, sigma=sigma, k1=k1, k2=k2)
    out = np.asarray(res)
    return float(out) if out.ndim == 0 else out
