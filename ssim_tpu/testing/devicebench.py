"""Steady-state device throughput measurement.

The methodology behind bench.py and chip_smoke.py's rates:

- the iteration loop runs *on device* inside one jit (lax.fori_loop with
  a traced trip count, so both loop lengths share one compilation), and
  host round-trip latency is paid once per measurement;
- the input is carried through the loop and perturbed by a one-pixel
  in-place update per step, making every iteration distinct work (no
  hoisting/CSE) without a full-array copy;
- throughput comes from the delta between a long and a short loop
  (cancelling fixed overhead), min-of-3 per length, median of reps.

Every number it returns is a device rate only when the caller ran it on
the accelerator; callers print the platform beside it.
"""

import time
from typing import Callable

import numpy as np


def _leaf_probe(x):
    """A scalar that depends on x without a full reduction of large
    outputs (maps, gradients)."""
    import jax.numpy as jnp

    if x.size <= 1 << 16:
        return jnp.sum(x.astype(jnp.float32))
    return x.reshape(-1)[0].astype(jnp.float32)


def device_rate(fn: Callable, a, b, *, iters: int = 64, reps: int = 3,
                pixels: int = 0) -> float:
    """Median-of-reps steady-state rate of fn(a, b) in Mpix/s.

    fn may return any pytree of arrays. pixels: pixels per call
    (default a.size)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(a, b, n):
        def body(i, state):
            a_c, acc = state
            flat = a_c.reshape(-1)
            flat = flat.at[0].set((flat[0] + 1).astype(a_c.dtype))
            a_c = flat.reshape(a_c.shape)
            for leaf in jax.tree.leaves(fn(a_c, b)):
                acc = acc + _leaf_probe(leaf)
            return a_c, acc

        _, acc = jax.lax.fori_loop(0, n, body, (a, jnp.float32(0.0)))
        return acc

    def timed(n):
        t0 = time.perf_counter()
        run(a, b, n).block_until_ready()
        return time.perf_counter() - t0

    short, long_ = max(1, iters // 8), iters
    timed(short)  # compile and warm up
    samples = []
    for _ in range(reps):
        ts = min(timed(short) for _ in range(3))
        tl = min(timed(long_) for _ in range(3))
        dt = tl - ts
        if dt <= 0.01 * tl:
            continue  # noise swamped this delta; try another rep
        samples.append((pixels or a.size) * (long_ - short) / dt / 1e6)
    if not samples:
        raise RuntimeError("unstable measurement: every delta was noise-dominated")
    return float(np.median(samples))


def correlated_pair(shape, seed: int = 7, dtype=np.uint8):
    """A seeded, correlated u8 pair (b = a + N(0, 8), clipped), cast to
    dtype. Uncorrelated pairs give SSIM ~ 0 and under-exercise the
    formula."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.normal(0, 8, a.shape).astype(np.int16)
    b = np.clip(a.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return a.astype(dtype), b.astype(dtype)


def make_fn(impl: str, with_map: bool = False):
    """The device call a benchmark cell times.

    impl: "xla" or "pallas" (the forward parts of that path), "auto" (the
    dispatch-chosen forward), "grad" / "grad_xla" (the gradient of the
    mean SSIM through the dispatch-chosen path / the XLA formulation's
    autodiff, f32 inputs), "msssim" (the 5-scale pyramid)."""
    import jax
    import jax.numpy as jnp

    if impl in ("grad", "grad_xla"):
        from ..api import ssim

        path = "auto" if impl == "grad" else "xla"

        def fn(a, b):
            return jax.grad(
                lambda x: jnp.sum(ssim(x, b, data_range=255.0, impl=path))
            )(a)
        return fn
    if impl == "msssim":
        from ..models.msssim import ms_ssim

        return lambda a, b: ms_ssim(a, b, data_range=255.0)
    from ..dispatch import Implementation, select_impl

    if select_impl(impl) == Implementation.PALLAS:
        from ..ops.routing import ssim_parts_auto as parts
    else:
        from ..ops.ssim_xla import ssim_parts_xla as parts
    return lambda a, b: parts(a, b, with_map=with_map)


def device_throughput(impl: str = "auto", with_map: bool = False,
                      batch: int = 8, h: int = 1080, w: int = 1920,
                      iters: int = 64, reps: int = 3, seed: int = 7) -> float:
    """Rate in Mpix/s of one benchmark cell on seeded correlated pairs
    (f32 for the gradient cells, u8 otherwise)."""
    import jax

    dtype = np.float32 if impl.startswith("grad") else np.uint8
    a, b = correlated_pair((batch, h, w), seed, dtype)
    return device_rate(make_fn(impl, with_map), jax.device_put(a),
                       jax.device_put(b), iters=iters, reps=reps)
