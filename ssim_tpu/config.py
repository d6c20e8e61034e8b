"""Runtime configuration.

The reference's config surface is compile-time only: CMake options ->
preprocessor defines (RMGR_SSIM_USE_DOUBLE, RMGR_SSIM_NO_OPENMP,
CMakeLists.txt:53-57) plus header-overridable knobs
(RMGR_SSIM_CACHE_LINE_SIZE etc., src/ssim.cpp:46-52). A JAX framework
reconfigures at trace time instead, so the equivalents are a small
dataclass + environment variables:

| reference                    | ssim_tpu                               |
|------------------------------|----------------------------------------|
| RMGR_SSIM_USE_DOUBLE         | precision="f64" arg / SSIM_TPU_PRECISION |
| Implementation enum override | impl= arg / SSIM_TPU_IMPL              |
| tile/cache-line knobs        | none (the kernel's tiles are constants) |
| RMGR_SSIM_NO_OPENMP          | n/a (host backend threads via OMP_NUM_THREADS) |

New surface: `enable_compile_cache()` turns on JAX's persistent
compilation cache, so a fresh process (the eager CLI, a test run, a
benchmark) loads what an earlier one compiled instead of compiling it
again. The reference has no analogue: its compile cost is paid once at
library build time, ours at trace time.
"""

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    """Process-wide defaults, overridable per-call via API kwargs."""

    #: Default implementation ("auto", "xla", "pallas", "reference", "host").
    impl: str = "auto"
    #: Default pixel precision ("f32" or "f64").
    precision: str = "f32"

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            impl=os.environ.get("SSIM_TPU_IMPL", "auto"),
            precision=os.environ.get("SSIM_TPU_PRECISION", "f32"),
        )


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg


def enable_compile_cache() -> Optional[str]:
    """Enable JAX's persistent compilation cache (idempotent, best-effort).

    The directory is JAX_COMPILATION_CACHE_DIR when that is set (and no
    other is set in code); otherwise the fixed `<source checkout>/.cache/
    xla_cache` when running from a source tree (pyproject.toml beside the
    package). An installed package outside a checkout gets no default
    directory. SSIM_TPU_COMPILE_CACHE=0 disables the cache.

    Returns the directory, or None when disabled or not usable (an
    unwritable directory never breaks callers — they just recompile).
    """
    if os.environ.get("SSIM_TPU_COMPILE_CACHE", "") == "0":
        return None
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if not cache_dir:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if not os.path.isfile(os.path.join(pkg_root, "pyproject.toml")):
            return None
        cache_dir = os.path.join(pkg_root, ".cache", "xla_cache")
    try:
        import jax

        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        # Cache everything, including fast compilations (the default only
        # persists compilations above a time threshold).
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except Exception:
        return None  # degrade to no cache, never break the caller
    return cache_dir
