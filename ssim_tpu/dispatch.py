"""Implementation registry and selection.

Parity with the reference's kernel SPI + runtime ISA dispatch
(src/ssim_internal.h:41-62, select_impl src/ssim.cpp:808-896): the
reference probes CPUID/HWCAP and fills three function-pointer slots per
ISA; callers (tests) can force an ISA and get a support bitmask back.

On an accelerator the compiler owns codegen, so "implementations" are
whole compute paths, not ISAs:

- ``reference`` — host NumPy f64 oracle (tests/ssim_naive.h equivalent),
- ``xla``       — pure-XLA fused path (ops/ssim_xla.py), every platform,
- ``pallas``    — the fused forward kernel (ops/ssim_pallas.py, Pallas
                  through Triton); compiled for the GPU only,
- ``host``      — native C++ CPU backend (ops/host.py), when built,
- ``auto``      — pallas on the GPU else xla (the reference's IMPL_AUTO,
                  src/ssim.cpp:935-945).

Like the reference, selection is probe-once-and-cache, and requesting an
unsupported implementation is an explicit error surfaced to the caller
(tests/rmgr-ssim-tests.cpp:231-232 skips on the same condition).
"""

import enum
import functools
from typing import Dict, Tuple

import jax

from .errors import UnsupportedError


class Implementation(enum.Enum):
    AUTO = "auto"
    REFERENCE = "reference"
    XLA = "xla"
    PALLAS = "pallas"
    HOST = "host"

    @classmethod
    def parse(cls, value) -> "Implementation":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise UnsupportedError(
                f"unknown implementation {value!r}; one of "
                f"{[m.value for m in cls]}"
            ) from None


@functools.lru_cache(maxsize=None)
def _probe() -> Dict[Implementation, bool]:
    """Probe available compute paths once (reference: lazy select_impl on
    first call, src/ssim.cpp:935-945)."""
    try:
        from .ops import host as _host

        host_ok = _host.is_available()
    except Exception:
        host_ok = False
    return {
        Implementation.REFERENCE: True,
        Implementation.XLA: True,
        # The kernel compiles only for the GPU; production code never
        # runs it in interpret mode.
        Implementation.PALLAS: backend_platform() == "gpu",
        Implementation.HOST: host_ok,
        Implementation.AUTO: True,
    }


def backend_platform() -> str:
    return jax.devices()[0].platform


def available_impls() -> Tuple[Implementation, ...]:
    """The support set, analogous to the reference's bitmask return of
    select_impl (src/ssim.cpp:808-814)."""
    probe = _probe()
    return tuple(impl for impl, ok in probe.items() if ok and impl != Implementation.AUTO)


def select_impl(impl="auto") -> Implementation:
    """Resolve `impl` to a concrete available implementation."""
    impl = Implementation.parse(impl)
    probe = _probe()
    if impl == Implementation.AUTO:
        return (
            Implementation.PALLAS
            if probe[Implementation.PALLAS]
            else Implementation.XLA
        )
    if not probe.get(impl, False):
        # The probe is cached (reference: probe-once select_impl,
        # src/ssim.cpp:935-945), but availability can legitimately change
        # within a process — e.g. the native host lib is built AFTER the
        # first probe. Re-probe once on the failing path only, so the
        # happy path stays cached and a newly-built backend is picked up
        # without a process restart.
        _probe.cache_clear()
        probe = _probe()
        if not probe.get(impl, False):
            raise UnsupportedError(
                f"implementation {impl.value!r} is not available here"
            )
    return impl
