"""Numeric kernels: the device equivalents of the reference's SIMD
backends (src/ssim_{sse,avx,fma,avx512,neon}.cpp) and per-tile pipeline
(src/ssim.cpp:747-791). Imports stay lazy below this package: the Pallas
kernel module is loaded only by the paths that run it."""

from .ssim_xla import ssim_parts_xla, blur_separable

__all__ = [
    "ssim_parts_xla",
    "blur_separable",
]
