"""Core engine: validation, dispatch, and high-precision finalization.

The device analogue of the reference's core engine
(compute_ssim, src/ssim.cpp:933-1106): validate inputs, select an
implementation, run the per-tile pipeline, and reduce partial sums into the
global score. Divergences are deliberate and documented:

- The reference's tiling loop / thread-pool job dispatch
  (src/ssim.cpp:902-926,1084-1086) lives inside the compute paths (kernel
  grid / XLA fusion); the engine only orchestrates.
- The reference accumulates in double no matter the pixel precision
  (src/ssim.cpp:594,1102). The f32 compute paths return f32 partial sums
  (per row or per tile) and the engine finalizes the mean in f64 on the
  host. Accuracy is validated against the oracle in the test suite, not
  assumed.
- The reference swallows dispatch errors when no global score is requested
  (src/ssim.cpp:1094-1097) and can overflow uint32 width*height
  (src/ssim.cpp:1102); we do neither.
"""

from typing import Optional, Tuple

import numpy as np

from .dispatch import Implementation, select_impl
from .errors import InvalidArgumentError


def validate_pair(a: np.ndarray, b: np.ndarray) -> None:
    """Input validation (reference EINVAL paths, src/ssim.cpp:962-978)."""
    if a.ndim not in (2, 3):
        raise InvalidArgumentError(f"images must be (H, W) or (B, H, W); got {a.shape}")
    if a.shape != b.shape:
        raise InvalidArgumentError(f"image shapes differ: {a.shape} vs {b.shape}")
    if a.shape[-1] < 1 or a.shape[-2] < 1:
        raise InvalidArgumentError(f"empty image: {a.shape}")
    if a.ndim == 3 and a.shape[0] < 1:
        raise InvalidArgumentError("empty batch")
    import jax.numpy as jnp

    for x in (a, b):
        # jnp.issubdtype (not np's) so the ml_dtypes low-precision floats
        # (bfloat16, float8s, etc.) are accepted; they route through the
        # f32 cast like float16 does.
        if not (
            jnp.issubdtype(x.dtype, jnp.integer)
            or jnp.issubdtype(x.dtype, jnp.floating)
        ):
            raise InvalidArgumentError(f"unsupported dtype {x.dtype}")


def validate_window(radius, sigma, k1, k2, data_range=None) -> None:
    """Validate the custom-window extension parameters (defaults are the
    reference contract: radius 5, sigma 1.5, k1 0.01, k2 0.03 —
    src/ssim.cpp:227-228, :956-960).

    With data_range given, also enforces the degeneracy floor once for
    EVERY compute path: c1*c2 = (k1*k2*data_range^2)^2 must stay a
    normal f32 (accelerators may flush subnormals, and below it the SSIM
    formula itself collapses), so every route fails loudly instead of
    returning NaN."""
    if isinstance(radius, bool) or not isinstance(radius, (int, np.integer)):
        raise InvalidArgumentError(f"radius must be an int >= 1, got {radius!r}")
    if radius < 1:
        raise InvalidArgumentError(f"radius must be >= 1, got {radius}")
    vals = {"sigma": sigma, "k1": k1, "k2": k2}
    for name, v in vals.items():
        if isinstance(v, bool) or not isinstance(
            v, (int, float, np.integer, np.floating)
        ):
            raise InvalidArgumentError(
                f"{name} must be a finite number > 0, got {v!r}"
            )
        if not (float(v) > 0.0 and np.isfinite(float(v))):
            raise InvalidArgumentError(
                f"{name} must be finite and > 0, got {v!r}"
            )
    if data_range is not None:
        c1 = (float(k1) * float(data_range)) ** 2
        c2 = (float(k2) * float(data_range)) ** 2
        if c1 * c2 < 9e-32:
            raise InvalidArgumentError(
                f"k1/k2 too small for data_range {data_range}: c1*c2 = "
                f"{c1 * c2:g} degenerates in f32 (needs >= 9e-32)"
            )


def window_is_default(radius, sigma, k1, k2) -> bool:
    from .windows import window_is_default as _wid

    return _wid(radius, sigma, k1, k2)


def accuracy_is_relaxed(accuracy) -> bool:
    """Validate an accuracy tier name and return whether it is the
    relaxed one. The single copy of the whitelist (api._relaxed and
    engine.compute both call this). "relaxed" is accepted for
    compatibility and computes at standard accuracy on every path."""
    if accuracy is None:
        return False
    if accuracy not in ("standard", "relaxed"):
        raise InvalidArgumentError(
            f'accuracy must be "standard" or "relaxed", got {accuracy!r}'
        )
    return accuracy == "relaxed"


def finalize_mean(partials: np.ndarray, npix: int) -> np.ndarray:
    """f64 host reduction of f32 partial sums -> global SSIM.

    Honors the reference's always-double accumulation (src/ssim.cpp:594);
    this is the host-side analogue of its final serial partial-sum reduce
    (src/ssim.cpp:1098-1102). partials: (..., K) per-row or per-tile f32
    sums; returns (...) float64 mean over npix pixels.
    """
    ps = np.asarray(partials, dtype=np.float64)
    return ps.sum(axis=-1) / np.float64(npix)


def downsample_factor(h: int, w: int) -> int:
    """The Wang-reference automatic prefilter factor: f = round(min/256).

    From the original MATLAB ssim_index.m (and adopted verbatim by
    pytorch-msssim and most IQA toolkits): large images are box-filtered
    and decimated so the 11x11 window keeps a perceptually meaningful
    footprint. Extension — the rmgr reference never downsamples.

    MATLAB round() is round-half-AWAY-from-zero (min side 640 -> 2.5 ->
    f=3), not Python banker's rounding (int(round(2.5)) == 2), hence the
    floor(x + 0.5) below.
    """
    return max(1, int(min(h, w) / 256.0 + 0.5))


def resolve_downsample(downsample, h: int, w: int) -> int:
    """Validate a downsample argument and resolve "auto" to the Wang
    factor for an h x w image. None -> 1 (no pooling)."""
    if downsample is None:
        return 1
    if downsample == "auto":
        return downsample_factor(h, w)
    if (
        isinstance(downsample, bool)  # True would silently mean k=1
        or not isinstance(downsample, (int, np.integer))
        or downsample < 1
    ):
        raise InvalidArgumentError(
            f'downsample must be "auto" or an int >= 1, got {downsample!r}'
        )
    return int(downsample)


def box_decimate(x: np.ndarray, k: int) -> np.ndarray:
    """k x k box mean + decimation (avg_pool, stride k, no padding); the
    trailing h % k / w % k pixels are dropped, matching avg-pool practice
    (pytorch-msssim F.avg_pool2d). Means are taken in f64, emitted f32."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = h // k, w // k
    if hh < 1 or ww < 1:
        raise InvalidArgumentError(
            f"downsample factor {k} collapses a {h}x{w} image"
        )
    x = x[..., : hh * k, : ww * k].astype(np.float64)
    x = x.reshape(x.shape[:-2] + (hh, k, ww, k)).mean(axis=(-3, -1))
    return x.astype(np.float32)


def compute(
    a,
    b,
    *,
    with_map: bool = False,
    impl=None,
    data_range: float = 255.0,
    precision: Optional[str] = None,
    downsample=None,
    accuracy: Optional[str] = None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Run SSIM end-to-end on host arrays.

    a, b: (H, W) or (B, H, W) uint8-like arrays.
    precision: "f32" (reference default Float) or "f64" (the reference's
    RMGR_SSIM_USE_DOUBLE build, src/ssim_internal.h:26-37). On the device
    impls the f64 mode runs the XLA formulation in float64 on the device
    (ssim_parts_xla(dtype=float64) under a scoped jax.enable_x64), for
    every input dtype, f64 inputs included, and any radius. impl="host"
    and impl="reference" serve it from the host NumPy f64 oracle.
    accuracy: "standard" (default) or "relaxed". "relaxed" is accepted
    for compatibility and computes at standard accuracy on every path;
    it is incompatible with precision="f64".
    downsample: None (reference parity — never downsample), "auto" (the
    Wang round(min/256) factor), or an int k >= 1: k x k box-mean +
    decimate prefilter (extension). The score and map then describe the
    pooled image (map is (H//k, W//k)); pooled pixels are float, so the
    computation rides the float path. Device impls pool on the device in
    f32 before either precision tier: for box areas that are powers of
    two (k=1,2,4,...) the division is exact; for other k (e.g. k=3,
    divide by 9) the pooled pixels round once at f32 (~2^-24 relative),
    far inside the reference double build's 5e-7 tier but not bitwise
    against a host f64-pooled oracle.
    radius/sigma/k1/k2 (extension; defaults = the reference contract,
    src/ssim.cpp:227-228 and :956-960): the Gaussian window's radius and
    spread and the stabilization constants, skimage/torchmetrics-style.
    They ride every device path (trace-time taps/constants); the fused
    kernel serves radius <= MAX_FUSED_RADIUS (16, ops/routing.py) and
    larger radii take the XLA path. Unsupported with impl="host" (the C
    backend pins the contract window).
    Returns (global_ssim float64 scalar or (B,), map f32 or None).
    """
    from .config import get_config

    cfg = get_config()
    if impl is None or impl == "auto":
        impl = cfg.impl
    if precision is None:
        precision = cfg.precision
    a = np.asarray(a)
    b = np.asarray(b)
    validate_pair(a, b)
    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    default_window = window_is_default(radius, sigma, k1, k2)
    downsample = resolve_downsample(downsample, a.shape[-2], a.shape[-1])
    if precision not in ("f32", "f64"):
        raise InvalidArgumentError(f"precision must be f32 or f64, got {precision!r}")
    if accuracy_is_relaxed(accuracy) and precision == "f64":
        raise InvalidArgumentError(
            'accuracy="relaxed" contradicts precision="f64" — pick one tier'
        )
    impl = select_impl(impl)
    if impl == Implementation.HOST and not default_window:
        raise InvalidArgumentError(
            "custom radius/sigma/k1/k2 are unsupported with impl='host' "
            "(the C backend pins the reference window) — use "
            "impl='auto'/'pallas'/'xla'"
        )
    precise = precision == "f64"
    if precise and impl == Implementation.HOST:
        # The C backend computes in f32; its double tier is the oracle.
        impl = Implementation.REFERENCE
    if downsample > 1:
        if impl == Implementation.HOST:
            # Pooling produces float images; the u8-only host backend
            # would reject them with a message blaming the caller's
            # (correct) input dtype — raise the targeted error instead.
            raise InvalidArgumentError(
                "downsample > 1 is unsupported with impl='host' (pooled "
                "images are float; the host backend is uint8-only) — "
                "use impl='auto'/'pallas'/'xla'"
            )
        if impl == Implementation.REFERENCE:
            # The f64 oracle keeps the host f64 pooling semantics.
            a = box_decimate(a, downsample)
            b = box_decimate(b, downsample)
        else:
            # Device paths pool on the device (reduce_window), so the
            # pooled f32 arrays flow straight into the compute path
            # without a host round-trip.
            from .ops.pool import box_decimate_device

            a = box_decimate_device(a, downsample)
            b = box_decimate_device(b, downsample)
    h, w = a.shape[-2], a.shape[-1]
    window = dict(data_range=data_range, radius=radius, sigma=sigma,
                  k1=k1, k2=k2)

    if impl == Implementation.REFERENCE:
        from . import reference

        # The oracle vectorizes over the batch (one NumPy blur pass for
        # the whole stack — no Python loop per image).
        g, m = reference.compute_ssim(a, b, with_map=with_map, **window)
        if a.ndim == 2:
            return np.float64(g), (None if m is None else m.astype(np.float32))
        return (
            np.asarray(g, dtype=np.float64),
            None if not with_map else m.astype(np.float32),
        )

    if impl == Implementation.HOST:
        from .ops import host

        return host.compute(a, b, with_map=with_map, data_range=data_range)

    if precise:
        # The double tier on the device: the XLA formulation in float64,
        # with x64 switched on for this call only.
        import jax
        import jax.numpy as jnp

        from .ops.ssim_xla import ssim_parts_xla

        with jax.enable_x64(True):
            partials, ssim_map = ssim_parts_xla(
                a, b, with_map=with_map, dtype=jnp.float64, **window
            )
            partials = np.asarray(partials)
            if ssim_map is not None:
                ssim_map = np.asarray(ssim_map).astype(np.float32)
        return finalize_mean(partials, h * w), ssim_map

    # Dtype routing lives in ops.routing (one policy shared with the
    # jittable APIs and the sharded layers). The XLA path also serves
    # every dtype the kernel does not: the API accepts float images
    # (data_range=1.0) and wider integer depths (e.g. uint16 with
    # data_range=65535; the reference requires a rebuild for those,
    # README.md:107-111).
    if impl == Implementation.PALLAS:
        from .ops.routing import ssim_parts_auto as parts_fn
    else:
        from .ops.ssim_xla import ssim_parts_xla as parts_fn
    partials, ssim_map = parts_fn(a, b, with_map=with_map, **window)

    global_ssim = finalize_mean(np.asarray(partials), h * w)
    return global_ssim, (None if ssim_map is None else np.asarray(ssim_map))
