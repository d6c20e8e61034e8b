"""Distributed SSIM over a device mesh.

Run on a multi-GPU host, or simulate locally:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/distributed.py
"""

# Runnable straight from a source checkout (no install needed).
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

import jax

from ssim_tpu import engine
from ssim_tpu.parallel import default_mesh, make_mesh, mean_ssim_sharded, \
    ssim_batch_sharded, ssim_spatial_sharded


def main():
    n = len(jax.devices())
    print(f"{n} devices: {jax.devices()}")
    rng = np.random.default_rng(0)

    # 1) Batch data parallelism: one image pair per device.
    mesh = default_mesh("data", n)
    a = rng.integers(0, 256, (n, 256, 384), dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 10, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    partials, _ = ssim_batch_sharded(a, b, mesh)
    scores = engine.finalize_mean(np.asarray(partials), 256 * 384)
    print("per-image SSIM (sharded):", np.round(scores, 4))
    print("mean via psum:", float(mean_ssim_sharded(a, b, mesh)))

    # 2) Spatial sharding: one big image, rows split across all devices.
    mesh_s = make_mesh((n,), ("space",))
    big_a = rng.integers(0, 256, (n * 128, 1024), dtype=np.uint8)
    big_b = np.clip(big_a + rng.normal(0, 6, big_a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    row_sums, _ = ssim_spatial_sharded(big_a, big_b, mesh_s)
    print("huge-image SSIM:", float(engine.finalize_mean(np.asarray(row_sums), big_a.size)))


if __name__ == "__main__":
    main()
