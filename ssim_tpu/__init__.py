"""ssim_tpu — an SSIM (Structural Similarity) framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of rmgr::ssim
(reference: C++98 + per-ISA SIMD), redesigned for accelerators:

- the reference's per-ISA SIMD kernels (ssim_sse/avx/fma/neon.cpp) collapse
  into one fused GPU kernel (Pallas through Triton) plus a pure-XLA path
  for every platform; XLA owns codegen the way CPUID dispatch owned it
  there (reference src/ssim.cpp:808-896),
- the reference's tile grid + injected thread pool (src/ssim.cpp:902-926,
  include/rmgr/ssim.h:451-466) becomes a kernel grid on one device and a
  `jax.sharding` mesh across devices,
- the double-precision global accumulation (src/ssim.cpp:594) becomes
  f32 pairwise tile sums finalized in f64 on the host.

Public API mirrors the reference's parameter surface (include/rmgr/ssim.h).
"""

from .version import __version__, get_version
from .errors import SsimError, InvalidArgumentError, UnsupportedError
from .params import ImageView, Params, write_strided_map
from .windows import gaussian_taps, gaussian_kernel_2d, RADIUS, SIGMA, C1, C2
from .api import (
    compute_ssim,
    compute_ssim_legacy,
    compute_ssim_map,
    ssim,
    ssim_and_map,
    ssim_loss,
)
from .dispatch import Implementation, select_impl, available_impls
from .config import Config, get_config, set_config
from .models import ms_ssim, compute_ms_ssim
from . import reference

__all__ = [
    "__version__",
    "get_version",
    "SsimError",
    "InvalidArgumentError",
    "UnsupportedError",
    "ImageView",
    "Params",
    "write_strided_map",
    "gaussian_taps",
    "gaussian_kernel_2d",
    "RADIUS",
    "SIGMA",
    "C1",
    "C2",
    "compute_ssim",
    "compute_ssim_legacy",
    "compute_ssim_map",
    "ssim",
    "ssim_and_map",
    "ssim_loss",
    "Implementation",
    "select_impl",
    "available_impls",
    "Config",
    "get_config",
    "set_config",
    "ms_ssim",
    "compute_ms_ssim",
    "reference",
]
