"""Public API.

Mirrors the reference's public surface (include/rmgr/ssim.h:428-732):

- `compute_ssim` — the eager entry point, parity with
  `rmgr::ssim::compute_ssim` (include/rmgr/ssim.h:686, src/ssim.cpp:933):
  takes images (arrays or ImageView/Params), returns the global SSIM as a
  Python float (f64-finalized), optionally with the per-pixel map.
- `ssim` / `ssim_and_map` — jittable on-device versions for use inside
  larger JAX programs (new surface; the global score is f32 on device,
  finalized by a compensated df32 reduction that matches
  `compute_ssim`'s host f64 finalize to f32 representability — see
  _device_finalize).
- `ssim_loss` — differentiable 1 - mean(SSIM) perceptual loss (new
  surface; the reference has no autodiff story).
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import engine
from .dispatch import Implementation, select_impl
from .params import ImageView, Params


def _unwrap(img) -> np.ndarray:
    if isinstance(img, ImageView):
        return img.data
    return np.asarray(img)


def compute_ssim(
    a,
    b=None,
    *,
    with_map: bool = False,
    impl=None,
    data_range: float = 255.0,
    precision=None,
    downsample=None,
    accuracy=None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
):
    """Global SSIM of two single-channel images (or batches of them).

    Accepts either (a, b) as arrays/ImageViews, or a single `Params`.
    Returns `float` (or (B,) float64 array), or `(score, map)` when
    `with_map`. Parity: rmgr::ssim::compute_ssim (src/ssim.cpp:933-1106).

    downsample (extension, default off = reference parity): "auto" or an
    int k — the Wang/pytorch-msssim k x k box-mean prefilter; the score
    and map then describe the pooled (H//k, W//k) image. Incompatible
    with a Params map_buffer (its layout is sized to the full image).

    accuracy (extension, default "standard" = reference-tier accuracy):
    "relaxed" is accepted for compatibility and computes at standard
    accuracy. See engine.compute.

    radius/sigma/k1/k2 (extension, defaults = the reference contract):
    custom Gaussian window and stabilization constants, skimage-style
    (win_size = 2*radius+1, gaussian_weights; K1/K2). See engine.compute
    for path routing.
    """
    params = None
    if isinstance(a, Params):
        params = a
        if b is not None:
            raise TypeError("pass either Params or two images, not both")
        a, b = params.img_a.data, params.img_b.data
        with_map = params.with_map or params.map_buffer is not None
        impl = params.implementation
        data_range = params.data_range
    if downsample is not None and params is not None and params.map_buffer is not None:
        # Only an EFFECTIVE pooling conflicts with the full-image-sized
        # map_buffer; "auto" on a small image (factor 1) and explicit
        # downsample=1 are exact no-ops and stay allowed.
        arr = _unwrap(a)
        if engine.resolve_downsample(downsample, arr.shape[-2], arr.shape[-1]) > 1:
            from .errors import InvalidArgumentError

            raise InvalidArgumentError(
                "downsample produces a pooled-size map; a strided map_buffer "
                "is laid out for the full image — drop one of the two"
            )
    score, ssim_map = engine.compute(
        _unwrap(a), _unwrap(b), with_map=with_map, impl=impl,
        data_range=data_range, precision=precision, downsample=downsample,
        accuracy=accuracy, radius=radius, sigma=sigma, k1=k1, k2=k2,
    )
    if params is not None and params.map_buffer is not None:
        # Reference ssimStep/ssimStride map layout (include/rmgr/ssim.h:514-516).
        from .params import write_strided_map

        stride = params.map_stride
        if stride is None:
            stride = ssim_map.shape[-1] * params.map_step
        write_strided_map(
            params.map_buffer, ssim_map, params.map_step, stride,
            params.map_offset,
        )
    score = float(score) if np.ndim(score) == 0 else score
    # A map_buffer alone (reference: ssimMap != NULL) doesn't change the
    # return shape — the map went into the caller's buffer.
    if params.with_map if params is not None else with_map:
        return score, ssim_map
    return score


def compute_ssim_map(a, b, *, impl="auto", data_range: float = 255.0):
    """Convenience: return (global_ssim, per-pixel map)."""
    return compute_ssim(a, b, with_map=True, impl=impl, data_range=data_range)


def compute_ssim_legacy(a, b=None, **kwargs) -> float:
    """Parity with the reference's deprecated float-returning overload
    (include/rmgr/ssim.h:712-728, impl src/ssim.cpp:1109-1120): returns
    the global SSIM, or the NEGATED errno as a float on failure instead
    of raising — the error-encoding contract the reference's own test
    harness exercises (tests/rmgr-ssim-tests.cpp:293-301). Accepts the
    same (a, b) / Params arguments as compute_ssim; note that
    constructing an inconsistent Params object raises at construction
    time (before this function can encode it), so pass raw images when
    the negative-errno encoding must cover shape errors. Prefer
    compute_ssim (exceptions carry the same errno values)."""
    from .errors import SsimError

    try:
        result = compute_ssim(a, b, **kwargs)
    except SsimError as e:
        return -float(e.errno)
    return result[0] if isinstance(result, tuple) else result


def _device_finalize(partials, n: int):
    """On-device f64-grade mean of the f32 partial sums: a compensated
    (df32) pairwise tree over the partials axis plus one compensated
    division by n. Matches the eager path's host f64 finalize
    (engine.finalize_mean — the reference's always-double accumulation,
    src/ssim.cpp:594) to f32 representability: a plain
    `jnp.sum(partials) / n` loses up to ~2e-6 at 4K (partials have
    magnitude ~1e3-1e5, so each f32 add rounds at ulp(total)); the df32
    tree keeps the full sum to ~1 ulp. Differentiable: every
    two_sum/two_prod branch has unit Jacobian in the data path, so
    autodiff through it equals autodiff through the plain mean."""
    from .ops.df32 import df_add, df_const, df_div

    hi, lo = partials, jnp.zeros_like(partials)
    k = hi.shape[-1]
    m = 1 << (k - 1).bit_length()
    if m != k:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, m - k)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    x = (hi, lo)
    while m > 1:
        m //= 2
        x = df_add(
            (x[0][..., :m], x[1][..., :m]), (x[0][..., m:], x[1][..., m:])
        )
    s = (x[0][..., 0], x[1][..., 0])
    return df_div(s, df_const(float(n)))[0]


def _run_metric(a, b, impl, data_range, with_map, radius=5, sigma=1.5,
                k1=0.01, k2=0.03):
    """Shared body of ssim/ssim_and_map/ssim_loss: validation, routing
    (ops.routing) and the gradient rule (with_xla_vjp for float inputs
    on the fused kernel)."""
    from .ops.routing import pallas_routable, with_xla_vjp
    from .ops.ssim_xla import ssim_parts_xla

    # Shapes and dtypes are static at trace time, so the same validation
    # the eager engine runs (reference EINVAL paths, src/ssim.cpp:962-978)
    # is free here — a mismatch raises InvalidArgumentError at trace time
    # instead of surfacing as a cryptic XLA broadcast error.
    engine.validate_pair(a, b)
    engine.validate_window(radius, sigma, k1, k2, data_range)
    window = dict(data_range=data_range, radius=int(radius), sigma=sigma,
                  k1=k1, k2=k2)
    n = a.shape[-1] * a.shape[-2]

    def metric(parts_fn):
        def forward(xa, xb):
            partials, ssim_map = parts_fn(xa, xb, with_map=with_map, **window)
            score = _device_finalize(partials, n)
            return (score, ssim_map) if with_map else score

        return forward

    xla_forward = metric(ssim_parts_xla)
    if not (
        select_impl(impl) == Implementation.PALLAS
        and pallas_routable(a, b, window["radius"])
    ):
        return xla_forward(a, b)
    from .ops.ssim_pallas import ssim_parts_pallas

    kernel_forward = metric(ssim_parts_pallas)
    if not jnp.issubdtype(a.dtype, jnp.floating):
        return kernel_forward(a, b)  # integer inputs have no gradient
    return with_xla_vjp(kernel_forward, xla_forward)(a, b)


@functools.partial(
    jax.jit,
    static_argnames=(
        "data_range", "impl", "accuracy", "radius", "sigma", "k1", "k2",
    ),
)
def ssim(
    a, b, *, data_range: float = 255.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03,
) -> jnp.ndarray:
    """Jittable global SSIM, f32 on device. a, b: (..., H, W).

    Returns scalar for 2-D inputs, (B,) for batched. The score is
    finalized on device by a compensated df32 reduction
    (_device_finalize) matching compute_ssim's host f64 finalize to f32
    representability. Differentiable for float inputs on every impl
    (see _run_metric for the gradient rule).

    accuracy: "standard" or "relaxed"; "relaxed" is accepted for
    compatibility and computes at standard accuracy.

    radius/sigma/k1/k2 (extension): custom window and stabilization
    constants. The fused kernel serves radius <= MAX_FUSED_RADIUS (16,
    ops/routing.py); larger radii ride the XLA path. See engine.compute.
    """
    _relaxed(accuracy)
    return _run_metric(a, b, impl, data_range, with_map=False,
                       radius=radius, sigma=sigma, k1=k1, k2=k2)


def _relaxed(accuracy: str) -> bool:
    return engine.accuracy_is_relaxed(accuracy)


@functools.partial(
    jax.jit,
    static_argnames=(
        "data_range", "impl", "accuracy", "radius", "sigma", "k1", "k2",
    ),
)
def ssim_and_map(
    a, b, *, data_range: float = 255.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittable (global_ssim, per-pixel map). Differentiable like ssim(),
    through the score and the per-pixel map alike. accuracy and
    radius/sigma/k1/k2 as in ssim()."""
    _relaxed(accuracy)
    return _run_metric(a, b, impl, data_range, with_map=True,
                       radius=radius, sigma=sigma, k1=k1, k2=k2)


@functools.partial(
    jax.jit,
    static_argnames=(
        "data_range", "impl", "accuracy", "radius", "sigma", "k1", "k2",
    ),
)
def ssim_loss(
    a, b, *, data_range: float = 1.0, impl: str = "auto",
    accuracy: str = "standard", radius: int = 5, sigma: float = 1.5,
    k1: float = 0.01, k2: float = 0.03,
) -> jnp.ndarray:
    """Differentiable perceptual loss: 1 - mean SSIM over the batch.

    Defaults to data_range=1.0 (float images in [0, 1]), the common
    training convention; pass 255.0 for u8-range inputs.

    impl: "auto" takes the fused kernel on the GPU and the XLA
    formulation elsewhere; "xla" forces the XLA path throughout. The
    gradient rule is _run_metric's.
    """
    _relaxed(accuracy)
    score = _run_metric(a, b, impl, data_range, with_map=False,
                        radius=radius, sigma=sigma, k1=k1, k2=k2)
    return 1.0 - jnp.mean(score)
