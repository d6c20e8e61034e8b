"""Spatial sharding: one huge image split by rows across the mesh.

Extension of the reference's overlapping-tile decomposition (each 256x64
tile carries a 5-px read halo so tiles are independent,
src/ssim.cpp:230-239): here each *device* owns a row band, and the r-row
blur halos move between neighbours with `jax.lax.ppermute` instead of
being re-read from shared memory. True image borders (shard 0's top,
shard n-1's bottom) use clamp-to-edge replication exactly like the
reference (src/ssim.cpp:560-582); interior shard boundaries use real
neighbor rows, so the sharded result equals the single-device result
(validated to tolerance in tests/test_distributed.py).

Arbitrary geometry: heights that don't divide the mesh (or shards that
would be thinner than the blur radius) are handled by internally padding
the image with edge-replicated rows — replicated rows are numerically
identical to the clamp-to-edge border rule, so the valid rows' values are
unchanged and the pad rows are sliced off the outputs. This mirrors the
reference's ragged-tile handling (partial tiles at the image edge,
src/ssim.cpp:227-239) rather than refusing the geometry.

Each shard computes its halo-extended band with the dispatch-chosen
forward: the fused kernel on the GPU (it reads the halo rows in place
and clamps columns itself), the XLA formulation elsewhere. Gradients are
autodiff through the XLA formulation and the ppermutes
(ops.routing.with_xla_vjp), on every platform.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..dispatch import Implementation, select_impl
from ..windows import RADIUS


def _use_kernel(impl, a, b, radius: int) -> bool:
    """Whether each shard runs the fused kernel (dispatch + routing)."""
    from ..ops.routing import pallas_routable

    return (
        select_impl("auto" if impl is None else impl) == Implementation.PALLAS
        and pallas_routable(a, b, radius)
    )


def _edge_replica(x: jnp.ndarray, row: int, radius: int) -> jnp.ndarray:
    """Row `row` of x replicated `radius` times along -2 (clamp-to-edge
    halo content)."""
    return jnp.take(x, jnp.full((radius,), row, jnp.int32), axis=-2)


def _exchange_halos(
    x: jnp.ndarray, axis: str, n_shards: int, radius: int
) -> jnp.ndarray:
    """(..., Hs, W) local rows -> (..., Hs + 2*radius, W) with r halo
    rows on each side: the top ones from the previous shard's bottom
    rows, the bottom ones from the next shard's top rows (two ppermutes
    over a full ring); the image-edge shards get clamp-to-edge replicas
    instead (reference src/ssim.cpp:560-582). Works for any dtype and
    any leading batch dims."""
    idx = jax.lax.axis_index(axis)
    down = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    up = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    top_halo = jax.lax.ppermute(x[..., -radius:, :], axis, down)
    bot_halo = jax.lax.ppermute(x[..., :radius, :], axis, up)
    top_halo = jnp.where(idx == 0, _edge_replica(x, 0, radius), top_halo)
    bot_halo = jnp.where(
        idx == n_shards - 1,
        _edge_replica(x, x.shape[-2] - 1, radius),
        bot_halo,
    )
    return jnp.concatenate([top_halo, x, bot_halo], axis=-2)


def _shard_parts(a_s, b_s, axis, n_shards, with_map, radius, window,
                 kernel):
    """Per-shard SSIM of a row band with vertical halos from the
    neighbours. Returns (row_sums (..., Hs), map (..., Hs, W) or None).

    kernel: the fused kernel over the band, computing only the owned
    rows; else the XLA formulation over the band with local horizontal
    edge pads."""
    hs = a_s.shape[-2]
    if kernel:
        from ..ops.ssim_pallas import ssim_parts_pallas

        _, smap = ssim_parts_pallas(
            _exchange_halos(a_s, axis, n_shards, radius),
            _exchange_halos(b_s, axis, n_shards, radius),
            with_map=True, radius=radius, row_offset=radius, out_h=hs,
            **window,
        )
        return jnp.sum(smap, axis=-1), (smap if with_map else None)
    from ..ops.ssim_xla import ssim_from_padded

    pad = [(0, 0)] * (a_s.ndim - 1) + [(radius, radius)]

    def padded(x):
        x = _exchange_halos(x.astype(jnp.float32), axis, n_shards, radius)
        return jnp.pad(x, pad, mode="edge")

    return ssim_from_padded(
        padded(a_s), padded(b_s), with_map=with_map, radius=radius, **window
    )


def _pad_rows_to(x: jnp.ndarray, h_pad: int) -> jnp.ndarray:
    """Edge-replicate bottom rows up to h_pad. Replicated rows are exactly
    what the clamp-to-edge border rule reads, so padding then slicing the
    outputs leaves the valid rows' SSIM values unchanged."""
    h = x.shape[-2]
    if h_pad == h:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, h_pad - h), (0, 0)]
    return jnp.pad(x, pad, mode="edge")


def ssim_spatial_sharded(
    a: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "space",
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = RADIUS,
    impl="auto",
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """SSIM of one (H, W) pair with rows sharded over `axis`.

    Any H >= 1 works: if H doesn't divide the axis size (or shards would
    be thinner than the blur radius), the image is internally padded with
    edge-replicated rows and the outputs are sliced back. Returns
    (row_sums (H,) f32, map (H, W) f32 or None), row-sharded over the mesh.

    impl: "auto" (the fused kernel per shard on the GPU), "pallas" or
    "xla". radius/sigma/k1/k2: the custom-window extension — radius also
    sets the halo exchange depth.
    """
    from ..engine import validate_window

    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    kernel = _use_kernel(impl, a, b, radius)
    return _spatial_rows(a, b, mesh, axis, with_map, radius,
                         dict(data_range=data_range, sigma=sigma, k1=k1,
                              k2=k2), kernel)


def _spatial_rows(a, b, mesh, axis, with_map, radius, window, kernel):
    """ssim_spatial_sharded after validation and routing."""
    n_shards = mesh.shape[axis]
    h = a.shape[-2]

    # Internal padded height: every shard at least `radius` rows tall so
    # one-neighbor halo exchange suffices.
    shard_h = max(-(-h // n_shards), radius)
    h_pad = shard_h * n_shards
    a = _pad_rows_to(jnp.asarray(a), h_pad)
    b = _pad_rows_to(jnp.asarray(b), h_pad)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(axis), P(axis, None)) if with_map else P(axis),
        # A pallas_call's outputs carry no varying-axes type.
        check_vma=not kernel,
    )
    def shard_fn(a_s, b_s):
        row_sums, ssim_map = _shard_parts(
            a_s, b_s, axis, n_shards, with_map, radius, window, kernel
        )
        return (row_sums, ssim_map) if with_map else row_sums

    # Under jit, so a call outside the caller's jit compiles once instead
    # of dispatching every primitive of the blur across the mesh.
    out = jax.jit(shard_fn)(a, b)
    if with_map:
        return out[0][:h], out[1][:h]
    return out[:h], None


def mean_ssim_spatial(
    a: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "space",
    batch_axis: Optional[str] = None,
    data_range: float = 255.0,
    impl="auto",
    radius: int = RADIUS,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Differentiable mean SSIM of a row-sharded (H, W) pair — or a
    (B, H, W) batch, optionally batch-sharded over a second mesh axis
    (the 2-D data x space composition) — the spatial-sharding training
    surface. The forward runs per shard as in ssim_spatial_sharded; the
    gradient is autodiff through the XLA formulation and the ppermutes.
    A single pair may have any height (see ssim_spatial_sharded); a
    batch needs H divisible by the `axis` size with shards at least
    `radius` rows tall.
    radius/sigma/k1/k2: the custom-window extension (radius also sets
    the halo depth).
    """
    from ..engine import validate_window
    from ..ops.routing import with_xla_vjp

    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if a.ndim not in (2, 3) or a.shape != b.shape:
        raise ValueError(
            f"mean_ssim_spatial takes one (H, W) pair or a (B, H, W) "
            f"batch, got {a.shape} vs {b.shape}"
        )
    if batch_axis is not None and a.ndim != 3:
        raise ValueError("batch_axis requires (B, H, W) inputs")
    h = a.shape[-2]
    n_shards = mesh.shape[axis]
    if a.ndim == 3 and (h % n_shards != 0 or h // n_shards < radius):
        raise ValueError(
            f"batched mean_ssim_spatial needs H={h} divisible by the "
            f"{axis!r} axis ({n_shards}) with shards >= {radius} rows"
        )
    window = dict(data_range=data_range, sigma=sigma, k1=k1, k2=k2)
    kernel = _use_kernel(impl, a, b, radius)

    def mean(use_kernel):
        def f(xa, xb):
            if xa.ndim == 2:
                rows, _ = _spatial_rows(xa, xb, mesh, axis, False, radius,
                                        window, use_kernel)
                return jnp.sum(rows) / xa.size
            return _sharded_sum(xa, xb, mesh, axis, batch_axis, radius,
                                window, use_kernel) / xa.size
        return f

    if kernel and jnp.issubdtype(a.dtype, jnp.floating):
        return with_xla_vjp(mean(True), mean(False))(a, b)
    return mean(kernel)(a, b)


def _sharded_sum(a, b, mesh, axis, batch_axis, radius, window, kernel):
    """Sum of the SSIM map over every pixel of a (B, H, W) batch with
    rows sharded over `axis` (and B over `batch_axis`), psum-reduced to a
    replicated scalar. H must divide the axis with shards >= radius."""
    n_shards = mesh.shape[axis]
    spec = P(batch_axis, axis, None)
    psum_axes = (axis,) + ((batch_axis,) if batch_axis else ())

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=P(),
        check_vma=not kernel,  # as in _spatial_rows
    )
    def shard_fn(xa, xb):
        row_sums, _ = _shard_parts(xa, xb, axis, n_shards, False, radius,
                                   window, kernel)
        return jax.lax.psum(jnp.sum(row_sums), psum_axes)

    return jax.jit(shard_fn)(a, b)  # jit: see _spatial_rows


def ssim_grad_spatial_sharded(
    a: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "space",
    batch_axis: Optional[str] = None,
    w_s=1.0,
    data_range: float = 255.0,
    interpret: Optional[bool] = None,
    radius: int = RADIUS,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(dL/da, dL/db) for L = w_s * sum_p SSIM(p) of ONE row-sharded
    float32 (H, W) pair, or of a (B, H, W) batch with rows sharded over
    `axis` and B optionally over `batch_axis` (the 2-D data x space
    composition). Computed by autodiff through the sharded XLA forward
    (_sharded_sum): each shard's gradient rows come back row-sharded like
    the inputs, with only the r-row halos crossing between devices.

    Requirements: float32 inputs (u8 has no gradient), H divisible by
    the axis size, and shards at least 2*radius rows tall. w_s may be a
    traced scalar (e.g. a loss cotangent / (H*W)). interpret is accepted
    for compatibility and ignored: no kernel runs here.

    Validated against jax.grad of the unsharded XLA formulation across
    shard counts and edge geometries (tests/test_distributed.py).
    """
    del interpret
    from ..engine import validate_window

    validate_window(radius, sigma, k1, k2, data_range)
    radius = int(radius)
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if a.ndim not in (2, 3) or a.shape != b.shape:
        raise ValueError(
            f"ssim_grad_spatial_sharded takes one (H, W) pair or a "
            f"(B, H, W) batch, got {a.shape} vs {b.shape}"
        )
    if batch_axis is not None and a.ndim != 3:
        raise ValueError("batch_axis requires (B, H, W) inputs")
    if a.dtype != jnp.float32 or b.dtype != jnp.float32:
        raise ValueError(
            f"float32 pairs required (u8 has no gradient), got "
            f"{a.dtype}/{b.dtype}"
        )
    n_shards = mesh.shape[axis]
    h = a.shape[-2]
    if h % n_shards != 0 or h // n_shards < 2 * radius:
        raise ValueError(
            f"H={h} must divide the {axis!r} axis ({n_shards}) with shards "
            f">= {2 * radius} rows tall; use fewer shards"
        )
    w_arr = jnp.asarray(w_s, jnp.float32)
    if w_arr.ndim != 0:
        raise ValueError(
            "w_s must be a scalar (per-image weights would need their own "
            f"sharding spec), got shape {w_arr.shape}"
        )
    window = dict(data_range=data_range, sigma=sigma, k1=k1, k2=k2)
    squeeze = a.ndim == 2
    if squeeze:
        a, b = a[None], b[None]

    def loss(xa, xb, ws):
        return ws * _sharded_sum(xa, xb, mesh, axis, batch_axis, radius,
                                 window, False)

    da, db = jax.jit(jax.grad(loss, argnums=(0, 1)))(a, b, w_arr)
    return (da[0], db[0]) if squeeze else (da, db)
