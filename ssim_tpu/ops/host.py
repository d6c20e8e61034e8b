"""Native C++ host (CPU) backend bridge.

The reference is a pure CPU library; this framework keeps a native CPU
path for parity and for deployments without an accelerator. The backend lives in
native/ssim_host.cpp (OpenMP + autovectorized separable blur — a fresh
design, not a port of the reference's scatter blur) and is loaded via
ctypes. Until the shared library is built (make -C native), this module
reports unavailable and the dispatcher hides the 'host' implementation.
"""

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libssim_host.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # Best-effort one-time build (the toolchain is a hard dependency
        # of this backend anyway; failure just reports unavailable).
        try:
            import subprocess

            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                capture_output=True, timeout=120, check=True,
            )
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.ssim_host_compute.restype = ctypes.c_int
    lib.ssim_host_compute.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # a
        ctypes.POINTER(ctypes.c_uint8),  # b
        ctypes.c_int,  # width
        ctypes.c_int,  # height
        ctypes.c_double,  # data_range
        ctypes.POINTER(ctypes.c_double),  # out global ssim
        ctypes.POINTER(ctypes.c_float),  # out map (or NULL)
    ]
    _LIB = lib
    return _LIB


def is_available() -> bool:
    return _load() is not None


def compute(
    a: np.ndarray,
    b: np.ndarray,
    *,
    with_map: bool = False,
    data_range: float = 255.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    lib = _load()
    if lib is None:
        raise RuntimeError("host backend not built; run `make -C native`")
    # Coerce array-likes (lists, torch tensors) BEFORE the dtype check so
    # e.g. a torch uint8 tensor is accepted (torch.uint8 != np.uint8 as
    # dtype objects, but asarray of it is a real u8 ndarray).
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype != np.uint8 or b.dtype != np.uint8:
        # The C backend takes u8 buffers; an implicit astype here would
        # silently truncate floats / wrap wider integers (the same bug
        # class the fused kernel guards against). The reference itself
        # is u8-only (README.md:107-111); float/u16 extensions live on
        # the XLA/Pallas paths.
        from ..errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"impl='host' supports uint8 images only, got {a.dtype}/"
            f"{b.dtype}; use impl='auto'/'pallas'/'xla' for float or "
            f"wider-integer inputs"
        )
    squeeze = a.ndim == 2
    if squeeze:
        a = a[None]
        b = b[None]
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    batch, h, w = a.shape
    scores = np.zeros(batch, dtype=np.float64)
    maps = np.zeros((batch, h, w), dtype=np.float32) if with_map else None
    for i in range(batch):
        out = ctypes.c_double()
        map_ptr = (
            maps[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if with_map
            else ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
        )
        rc = lib.ssim_host_compute(
            a[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            b[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w,
            h,
            data_range,
            ctypes.byref(out),
            map_ptr,
        )
        if rc != 0:
            raise RuntimeError(f"host backend error {rc}")
        scores[i] = out.value
    if squeeze:
        return np.float64(scores[0]), (None if maps is None else maps[0])
    return scores, maps
