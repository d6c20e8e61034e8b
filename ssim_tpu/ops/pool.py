"""Device-side box-mean decimation (the `downsample` prefilter).

The k x k box mean + stride-k decimation (Wang ssim_index.m automatic
prefilter; engine.resolve_downsample) on the device, so a
`downsample="auto"` call on a large pair is not dominated by host
pooling. It is the add-`reduce_window` pattern of the MS-SSIM pyramid
(models/msssim._downsample2).

Numerics vs the host f64 version (engine.box_decimate): for uint8
inputs the f32 window sum is EXACT whenever k^2 * 255 < 2^24, i.e.
k <= 256 — which covers every AUTOMATIC factor (round(min/256) stays
far below that) and any sane explicit one; an explicit user factor
k >= 257 loses the exact-sum guarantee and degrades gracefully to
~1-ulp-per-addition accumulation error (still orders below the metric
tolerances); the final division by the exact constant k^2 is
then within 1 ulp of the true mean — XLA rewrites divide-by-constant
into multiply-by-reciprocal (e.g. 1555/9 comes back 1 ulp off under
jit), so exactly-rounded division is not available inside jit. Power-of-two factors (the
common auto factors 2, 4, 8) are exact. For float inputs the window sum
adds ~k^2 ulp more. All of it is orders below the metric's f32
tolerance tiers; callers needing the f64 semantics (the
reference-oracle path) keep the host version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvalidArgumentError


@functools.partial(jax.jit, static_argnames=("k",))
def box_decimate_device(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """k x k box mean + decimation on device (avg_pool, stride k, no
    padding); trailing h % k / w % k pixels are dropped, matching
    engine.box_decimate and avg-pool practice. Returns float32."""
    h, w = x.shape[-2], x.shape[-1]
    hh, ww = h // k, w // k
    if hh < 1 or ww < 1:
        raise InvalidArgumentError(
            f"downsample factor {k} collapses a {h}x{w} image"
        )
    x = x[..., : hh * k, : ww * k].astype(jnp.float32)
    dims = (1,) * (x.ndim - 2) + (k, k)
    s = jax.lax.reduce_window(x, np.float32(0), jax.lax.add, dims, dims, "VALID")
    return s / np.float32(k * k)
