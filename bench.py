"""Benchmark: SSIM throughput on the GPU.

Prints ONE JSON line naming the device (platform, device_kind, count),
every cell's rate in Mpix/s, and the best forward cell as the headline
against the reference's best full-machine number, 232.4 Mpix/s (FMA +
OpenMP, no map — reference README.md:48, mirrored in BASELINE.md).
Exits non-zero when there is no GPU or when any cell fails; a failed
cell is listed on stderr, never reported as a number.

Cells pair the dispatch-chosen forward ("auto": the fused kernel on the
GPU) with the XLA formulation at the same shapes, so the kernel's gain
is read in one run. Methodology: ssim_tpu/testing/devicebench.py.
"""

import json
import sys

SHAPES = {
    "1080_b8": dict(batch=8, h=1080, w=1920),
    "4k_b4": dict(batch=4, h=2160, w=3840),
    "8k_b1": dict(batch=1, h=4320, w=7680),
    "128sq_b1024": dict(batch=1024, h=128, w=128),
}


def cells():
    for name, shape in SHAPES.items():
        for impl in ("auto", "xla"):
            yield f"{impl}_{name}_nomap", dict(impl=impl, **shape)
    for impl in ("auto", "xla"):
        yield f"{impl}_1080_b8_map", dict(impl=impl, with_map=True,
                                          **SHAPES["1080_b8"])
    yield "grad_1080_b4", dict(impl="grad", batch=4, h=1080, w=1920, iters=32)
    yield "grad_xla_1080_b4", dict(impl="grad_xla", batch=4, h=1080, w=1920,
                                   iters=32)
    yield "msssim_1080_b4", dict(impl="msssim", batch=4, h=1080, w=1920,
                                 iters=32)


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1

    from ssim_tpu.config import enable_compile_cache
    from ssim_tpu.testing.devicebench import device_throughput

    enable_compile_cache()
    results, failed = {}, []
    for name, kwargs in cells():
        try:
            results[name] = device_throughput(**kwargs)
        except Exception as e:  # report every failed cell, then fail
            print(f"bench {name} failed: {type(e).__name__}: {str(e)[:300]}",
                  file=sys.stderr)
            failed.append(name)
    if failed:
        print(f"bench: failed cells: {failed}", file=sys.stderr)
        return 1
    best = max(v for k, v in results.items() if k.startswith("auto_"))
    baseline = 232.4  # reference FMA+OpenMP no-map Mpix/s (README.md:48)
    print(json.dumps({
        "metric": "ssim_throughput",
        "value": best,
        "unit": "Mpix/s",
        "vs_baseline": best / baseline,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "cells": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
