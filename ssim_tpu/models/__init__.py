"""Metric "model families".

The reference library implements exactly one metric — single-scale SSIM
(README.md:4-6). This package hosts that metric's variants plus
extensions (clearly labeled; no reference analogue):

- ssim: the core metric, re-exported from the package root.
- msssim: multi-scale SSIM (Wang, Simoncelli & Bovik 2003), built on the
  same fused blur primitives — an extension the reference does not have.
"""

from .msssim import ms_ssim, compute_ms_ssim, MS_SSIM_WEIGHTS

__all__ = ["ms_ssim", "compute_ms_ssim", "MS_SSIM_WEIGHTS"]
