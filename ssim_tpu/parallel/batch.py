"""Batch data parallelism: image pairs sharded across the mesh.

The device analogue of the reference's thread-pool dispatch
(src/ssim.cpp:1061, contract include/rmgr/ssim.h:451-466): work units
(whole image pairs, instead of 256x64 tiles) are distributed to workers
(devices, instead of threads), partial results stay worker-local
(sharded outputs, instead of per-thread ThreadParams.value at
src/ssim.cpp:916), and the global reduction is an XLA psum (instead of
the serial loop at src/ssim.cpp:1098-1099).
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..dispatch import Implementation, select_impl


def _parts_fn(impl, window):
    """Resolve the per-shard compute path: the routed fused kernel for
    Implementation.PALLAS (the GPU's default), the XLA path otherwise.
    window: radius/sigma/k1/k2 of the custom-window extension."""
    if select_impl(impl) == Implementation.PALLAS:
        from ..ops.routing import ssim_parts_auto as parts
    else:
        from ..ops.ssim_xla import ssim_parts_xla as parts

    def run(a, b, with_map, data_range):
        return parts(a, b, with_map=with_map, data_range=data_range,
                     **window)

    return run


def ssim_batch_sharded(
    a: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "data",
    with_map: bool = False,
    data_range: float = 255.0,
    impl="auto",
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Per-image SSIM over a sharded batch.

    a, b: (B, H, W) with B divisible by the mesh axis size. Returns
    (partials (B, K) f32 per-image partial sums, map (B, H, W) or None),
    both sharded over the batch axis — maps never leave their device,
    like the reference's tile-local map writes (src/ssim.cpp:659-668).
    Finalize with engine.finalize_mean(partials, H*W).
    radius/sigma/k1/k2: the custom-window extension (see engine.compute).
    """
    from ..engine import validate_window

    validate_window(radius, sigma, k1, k2, data_range)
    parts = _parts_fn(
        impl, dict(radius=int(radius), sigma=sigma, k1=k1, k2=k2)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)) if with_map else (P(axis), P()),
        # The kernel's pallas_call outputs carry no varying-axes type.
        check_vma=False,
    )
    def shard_fn(a_s, b_s):
        partials, ssim_map = parts(a_s, b_s, with_map, data_range)
        if not with_map:
            return partials, jnp.zeros((), jnp.float32)  # placeholder
        return partials, ssim_map

    # Under jit, so a call outside the caller's jit compiles once instead
    # of dispatching every primitive across the mesh.
    partials, ssim_map = jax.jit(shard_fn)(a, b)
    return partials, (ssim_map if with_map else None)


def mean_ssim_sharded(
    a: jnp.ndarray,
    b: jnp.ndarray,
    mesh: Mesh,
    *,
    axis: str = "data",
    data_range: float = 255.0,
    impl="auto",
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Mean SSIM over a sharded batch, reduced with psum —
    the distributed equivalent of the reference's final serial reduce
    (src/ssim.cpp:1098-1099). Returns a replicated f32 scalar.
    radius/sigma/k1/k2: the custom-window extension (see engine.compute)."""
    from ..engine import validate_window

    validate_window(radius, sigma, k1, k2, data_range)
    n = a.shape[-1] * a.shape[-2]
    batch = a.shape[0]
    parts = _parts_fn(
        impl, dict(radius=int(radius), sigma=sigma, k1=k1, k2=k2)
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,  # as in ssim_batch_sharded
    )
    def shard_fn(a_s, b_s):
        partials, _ = parts(a_s, b_s, False, data_range)
        local = jnp.sum(partials) / n  # sum of this shard's per-image SSIMs
        return jax.lax.psum(local, axis) / batch

    return jax.jit(shard_fn)(a, b)  # jit: see ssim_batch_sharded
