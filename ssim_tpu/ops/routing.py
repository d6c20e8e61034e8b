"""Shared routing between the fused forward kernel and the XLA path.

One policy, used by engine.compute, the jittable APIs (api._run_metric)
and the sharded layers (parallel.batch), kept in one place so the gates
cannot drift:

- uint8 pairs, and same-dtype float or uint16 pairs, ride the fused
  kernel (ops/ssim_pallas.py), which loads them natively and computes
  in f32 (exact for u8/u16 and for any value below 2^24);
- radii beyond MAX_FUSED_RADIUS, mixed dtypes and other integer types
  take the XLA path.

Works on NumPy arrays (engine) and traced jnp arrays (jit) alike; all
branching is on static dtypes and shapes.
"""

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: Largest window radius the fused kernel serves; the kernel keeps a
#: ring of 2r+1 blurred rows in registers, so the bound caps register
#: pressure. Larger radii route to the XLA path.
MAX_FUSED_RADIUS = 16


def _is_float_routable(dt) -> bool:
    # jnp.issubdtype so bfloat16 (kind "V" to NumPy) counts as a float.
    return jnp.issubdtype(dt, jnp.floating) or np.dtype(dt) == np.uint16


def pallas_routable(a, b, radius: int = 5) -> bool:
    """Whether the fused kernel takes this pair at this window radius."""
    if radius > MAX_FUSED_RADIUS:
        return False
    return (a.dtype == jnp.uint8 and b.dtype == jnp.uint8) or (
        a.dtype == b.dtype and _is_float_routable(a.dtype)
    )


def ssim_parts_auto(
    a,
    b,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Fused kernel when the pair and radius allow it, XLA otherwise.
    Callers choose this only for Implementation.PALLAS, which dispatch
    offers on the GPU alone."""
    window = dict(data_range=data_range, radius=radius, sigma=sigma,
                  k1=k1, k2=k2)
    if pallas_routable(a, b, radius):
        from .ssim_pallas import ssim_parts_pallas

        return ssim_parts_pallas(a, b, with_map=with_map, **window)
    from .ssim_xla import ssim_parts_xla

    return ssim_parts_xla(a, b, with_map=with_map, **window)


def with_xla_vjp(kernel_forward, xla_forward):
    """kernel_forward as the primal, differentiated as xla_forward.

    A pallas_call has no autodiff rule, so under differentiation the
    forward runs as the XLA formulation and its autodiff VJP is the
    backward: a gradient costs exactly what plain autodiff costs, and a
    primal-only call keeps the kernel. (An analytic VJP in plain jnp was
    slower than autodiff on an H100; see PERF.md.)"""

    @jax.custom_vjp
    def f(xa, xb):
        return kernel_forward(xa, xb)

    def f_fwd(xa, xb):
        return jax.vjp(xla_forward, xa, xb)

    def f_bwd(vjp, g):
        return vjp(g)

    f.defvjp(f_fwd, f_bwd)
    return f
