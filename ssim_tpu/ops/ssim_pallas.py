"""Fused SSIM forward kernel for the GPU (Pallas, Triton route).

One program per (image, row tile, column tile). It streams the tile's
input rows plus an r-row halo above and below, and keeps nothing in
device memory between the input and the outputs:

- loads: each input row is read at the 2r+1 clamped column offsets of
  the window (the clamp-to-edge border rule, src/ssim.cpp:497-583, as
  index clamping, so no padded copy of the input is ever written). u8,
  u16 and float inputs are loaded in their own dtype and converted to
  f32 in registers;
- signals: a, b, (a+b)^2 and (a-b)^2 — one blur fewer than the five
  signals of ops/ssim_xla.py — blurred horizontally as the row is read;
- vertical blur: a ring of the last 2r+1 horizontally blurred rows lives
  in registers, so each output row costs one new input row;
- outputs: the SSIM formula per pixel, the map row when asked for, and
  one f32 partial sum per program. The cross-program sum is left to the
  caller (engine.finalize_mean on the host, api._device_finalize on the
  device), because programs run in no fixed order.

All arithmetic is plain f32 FMA on the CUDA cores: there is no matrix
product, so TF32 never enters. Tiles are fixed powers of two chosen on an
H100 (64 x 128, four warps; see PERF.md); radius up to
routing.MAX_FUSED_RADIUS.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..windows import RADIUS, SIGMA, gaussian_taps

TILE_H = 64
TILE_W = 128
NUM_WARPS = 4


def _kernel(a_ref, b_ref, *out_refs, h, w, row_offset, out_h, radius, taps,
            c1, c2, with_map):
    p_ref = out_refs[0]
    r = radius
    bi = pl.program_id(0)
    ti = pl.program_id(1)
    tj = pl.program_id(2)
    row0 = row_offset + ti * TILE_H
    cols = tj * TILE_W + jnp.arange(TILE_W, dtype=jnp.int32)
    ccols = [jnp.clip(cols + d, 0, w - 1) for d in range(-r, r + 1)]

    def hpass(i):
        """Horizontally blurred (a, b, (a+b)^2, (a-b)^2) of input row
        row0 - r + i (clamped to the image)."""
        row = jnp.clip(row0 - r + i, 0, h - 1)

        def signals(k):
            a = a_ref[bi, row, ccols[k]].astype(jnp.float32)
            b = b_ref[bi, row, ccols[k]].astype(jnp.float32)
            s = a + b
            d = a - b
            return a, b, s * s, d * d

        return _symmetric_sum(signals, taps, r)

    def vpass(ring):
        return _symmetric_sum(lambda k: ring[k], taps, r)

    def prime(i, ring):
        return ring[1:] + (hpass(i),)

    def body(i, carry):
        ring, colsum = carry
        ring = ring[1:] + (hpass(i),)
        mu_a, mu_b, ss, dd = vpass(ring)
        mu_ab = mu_a * mu_b
        mu_sq = mu_a * mu_a + mu_b * mu_b
        num = (2.0 * mu_ab + c1) * ((0.5 * (ss - dd) - 2.0 * mu_ab) + c2)
        den = (mu_sq + c1) * ((0.5 * (ss + dd) - mu_sq) + c2)
        smap = num / den
        out_row = row0 + i - 2 * r - row_offset
        valid = (cols < w) & (out_row < out_h)
        if with_map:
            plgpu.store(
                out_refs[1].at[bi, jnp.minimum(out_row, out_h - 1),
                               pl.ds(tj * TILE_W, TILE_W)],
                smap, mask=valid,
            )
        return ring, colsum + jnp.where(valid, smap, 0.0)

    zero = jnp.zeros((TILE_W,), jnp.float32)
    ring = tuple((zero,) * 4 for _ in range(2 * r + 1))
    ring = jax.lax.fori_loop(0, 2 * r, prime, ring)
    _, colsum = jax.lax.fori_loop(2 * r, TILE_H + 2 * r, body, (ring, zero))
    p_ref[bi, ti, tj] = jnp.sum(colsum)


def _symmetric_sum(term, taps, r):
    """sum_k taps[k] * term(k) over the 2r+1 taps, for 4-tuples of
    arrays: symmetric pairs first, smallest taps first (the order of
    ops/ssim_xla.blur_separable)."""
    acc = None
    for k in range(r):
        t = float(taps[k])
        pair = tuple(t * (x + y) for x, y in zip(term(k), term(2 * r - k)))
        acc = pair if acc is None else tuple(p + q for p, q in zip(acc, pair))
    t = float(taps[r])
    return tuple(p + t * q for p, q in zip(acc, term(r)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "with_map", "data_range", "radius", "sigma", "k1", "k2",
        "row_offset", "out_h", "interpret",
    ),
)
def ssim_parts_pallas(
    a: jnp.ndarray,
    b: jnp.ndarray,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = RADIUS,
    sigma: float = SIGMA,
    k1: float = 0.01,
    k2: float = 0.03,
    row_offset: int = 0,
    out_h: Optional[int] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Fused SSIM of (..., H, W) pairs of one dtype (u8, u16 or float).

    Returns (partials (..., K) f32 — one sum per kernel program, to be
    reduced by the caller — and the f32 map (..., out_h, W) or None).
    row_offset/out_h: compute only the out_h rows starting at row
    row_offset (default: all H rows); the rows outside are read as halo.
    The spatial-sharding layer passes a band with r neighbour rows above
    and below. interpret=True runs the Pallas interpreter; only tests on
    a machine without a GPU ask for it.
    """
    if a.shape != b.shape or a.dtype != b.dtype or not (
        a.dtype in (jnp.uint8, jnp.uint16) or jnp.issubdtype(a.dtype, jnp.floating)
    ):
        raise ValueError(
            "the fused kernel takes two same-shape arrays of one dtype out "
            f"of uint8, uint16 or float; got {a.shape} {a.dtype} and "
            f"{b.shape} {b.dtype}"
        )
    lead = a.shape[:-2]
    h, w = a.shape[-2], a.shape[-1]
    a3 = a.reshape((-1, h, w))
    b3 = b.reshape((-1, h, w))
    bsz = a3.shape[0]
    out_h = h - row_offset if out_h is None else out_h
    nh = -(-out_h // TILE_H)
    nw = -(-w // TILE_W)
    kern = functools.partial(
        _kernel, h=h, w=w, row_offset=row_offset, out_h=out_h,
        radius=int(radius),
        taps=gaussian_taps(np.float32, int(radius), sigma),
        c1=float(np.float32((k1 * data_range) ** 2)),
        c2=float(np.float32((k2 * data_range) ** 2)),
        with_map=with_map,
    )
    out_shape = [jax.ShapeDtypeStruct((bsz, nh, nw), jnp.float32)]
    if with_map:
        out_shape.append(jax.ShapeDtypeStruct((bsz, out_h, w), jnp.float32))
    anyspec = pl.BlockSpec(memory_space=pl.ANY)
    outs = pl.pallas_call(
        kern,
        out_shape=out_shape,
        grid=(bsz, nh, nw),
        in_specs=[anyspec, anyspec],
        out_specs=[anyspec] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ssim_fused_fwd",
    )(a3, b3)
    partials = outs[0].reshape(lead + (nh * nw,))
    ssim_map = outs[1].reshape(lead + (out_h, w)) if with_map else None
    return partials, ssim_map
