"""SSIM as a differentiable perceptual loss — denoising a batch of images
by gradient descent on 1 - SSIM (an optimization the reference's C++
library cannot express; this is extension surface).

    python examples/training.py
"""

# Runnable straight from a source checkout (no install needed).
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

import jax
import jax.numpy as jnp
import optax

from ssim_tpu import ssim_loss


def main():
    rng = np.random.default_rng(0)
    clean = rng.random((4, 96, 128), dtype=np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.15, clean.shape).astype(np.float32), 0, 1)

    params = jnp.asarray(noisy)
    target = jnp.asarray(clean)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)

    @jax.jit
    def step_fn(params, opt_state):
        loss, g = jax.value_and_grad(lambda x: ssim_loss(x, target))(params)
        updates, opt_state = opt.update(g, opt_state)
        params = jnp.clip(optax.apply_updates(params, updates), 0.0, 1.0)
        return params, opt_state, loss

    for step in range(120):
        params, opt_state, loss = step_fn(params, opt_state)
        if step % 20 == 0:
            print(f"step {step:3d}  1-SSIM = {float(loss):.4f}")
    print(f"final  1-SSIM = {float(ssim_loss(params, target)):.4f}")


if __name__ == "__main__":
    main()
