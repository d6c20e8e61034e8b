"""Native C++ host backend tests (ops/host.py + native/ssim_host.cpp):
the CPU-deployment parity path, differentially tested like every other
implementation."""

import subprocess

import numpy as np
import pytest

from ssim_tpu import reference
from ssim_tpu.testing import frozen

from conftest import random_pair


@pytest.fixture(scope="module")
def host():
    from ssim_tpu.ops import host as host_mod

    if not host_mod.is_available():
        try:
            subprocess.run(
                ["make", "-C", "native"], cwd=host_mod._lib_path().rsplit("/", 2)[0],
                check=True, capture_output=True, timeout=120,
            )
        except Exception as e:
            pytest.skip(f"cannot build native backend: {e}")
        host_mod._TRIED = False  # re-probe
        if not host_mod.is_available():
            pytest.skip("native backend unavailable after build")
    return host_mod


@pytest.mark.parametrize("shape", [(1, 1), (9, 13), (63, 255), (128, 200)])
def test_host_vs_oracle(rng, host, shape):
    a, b = random_pair(rng, *shape)
    want, want_map = reference.compute_ssim(a, b, with_map=True)
    got, got_map = host.compute(a, b, with_map=True)
    npix = shape[0] * shape[1]
    tol = max(frozen.GLOBAL_TOLERANCE_F32, 2e-3 / npix**0.5)
    assert abs(float(got) - want) < tol
    assert np.abs(got_map - want_map).max() < frozen.PIXEL_TOLERANCE_F32


def test_host_einstein_frozen(host, images_dir):
    import os

    from ssim_tpu.utils import load_image

    ref = load_image(os.path.join(images_dir, "einstein.png"))
    for name, want in frozen.EINSTEIN_SUITE.items():
        img = load_image(os.path.join(images_dir, name))
        got, _ = host.compute(img, ref)
        assert abs(float(got) - want) < frozen.GLOBAL_TOLERANCE_F32, (name, got)


def test_host_via_engine(rng, host):
    from ssim_tpu import compute_ssim

    a, b = random_pair(rng, 64, 96)
    got = compute_ssim(a, b, impl="host")
    want, _ = reference.compute_ssim(a, b)
    assert got == pytest.approx(want, abs=2e-6)


def test_host_batched(rng, host):
    a1, b1 = random_pair(rng, 32, 48)
    a2, b2 = random_pair(rng, 32, 48)
    scores, maps = host.compute(
        np.stack([a1, a2]), np.stack([b1, b2]), with_map=True
    )
    assert scores.shape == (2,)
    assert maps.shape == (2, 32, 48)
    s1, _ = host.compute(a1, b1)
    assert scores[0] == pytest.approx(float(s1), abs=1e-12)


def test_host_rejects_non_u8(rng, host):
    """float/u16 inputs must raise, not silently truncate/wrap to u8 —
    the guard that already protects the fused kernel (ADVICE r1)."""
    import pytest

    from conftest import random_pair
    from ssim_tpu.errors import InvalidArgumentError

    a, b = random_pair(rng, 32, 40)
    for bad in (np.float32, np.uint16):
        with pytest.raises(InvalidArgumentError):
            host.compute(a.astype(bad), b.astype(bad))
    # downsample produces pooled floats -> same rejection through the API
    from ssim_tpu import api

    with pytest.raises(InvalidArgumentError):
        api.compute_ssim(a, b, impl="host", downsample=2)


def test_host_multithread_bands_match_oracle(rng):
    """The per-thread row-band + ring-buffer + halo-recompute logic only
    executes with >= 2 OpenMP threads; force 4 threads in a subprocess
    (they timeshare this 1-core VM — correctness is what's under test)
    and check band boundaries against the single-thread result."""
    import os
    import subprocess
    import sys

    code = r"""
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from ssim_tpu.ops import host
from ssim_tpu import reference
assert host.is_available()
rng = np.random.default_rng(404)
# Heights chosen so bands are ragged and some threads get partial/empty
# bands (h=7 with 4 threads: band_h=2, last band 1 row; h=130: bands of
# 33/33/33/31 with halo recompute at three interior boundaries).
for h, w in [(130, 96), (7, 64), (64, 257)]:
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.normal(0, 12, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
    got, gmap = host.compute(a, b, with_map=True)
    want, wmap = reference.compute_ssim(a, b, with_map=True)
    g = float(np.atleast_1d(np.asarray(got))[0])
    assert abs(g - want) < 2e-6, (h, w, g, want)
    assert np.abs(np.asarray(gmap) - wmap).max() < 1e-3, (h, w)
print("OK")
"""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "4"
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


@pytest.mark.slow  # a wall-clock ratio; it cannot hold beside other workers
def test_host_thread_scaling(rng):
    """OpenMP thread SCALING of the native host backend — the
    reference's headline table is 1T -> 8T scaling on its own machine
    (README.md:45-48). Needs real cores: auto-skips on single-core VMs
    (this repo's usual environment; correctness of the banded
    multithread path is covered above on 1 core by oversubscription).
    When cores exist: throughput at OMP_NUM_THREADS=nproc must beat
    1-thread by >= 1.3x (a deliberately loose floor — bands scale
    near-linearly on real cores)."""
    import os
    import subprocess
    import sys

    ncpu = os.cpu_count() or 1
    if ncpu < 2:
        pytest.skip("thread scaling needs >= 2 cores (nproc == 1)")

    code = r"""
import time
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from ssim_tpu.ops import host
assert host.is_available()
rng = np.random.default_rng(11)
a = rng.integers(0, 256, (1080, 1920), dtype=np.uint8)
b = np.clip(a.astype(np.int16) + rng.normal(0, 12, a.shape).astype(np.int16), 0, 255).astype(np.uint8)
host.compute(a, b)  # warmup
reps = 5
t0 = time.perf_counter()
for _ in range(reps):
    host.compute(a, b)
dt = (time.perf_counter() - t0) / reps
print("MPIXS", a.size * 1e-6 / dt)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(threads):
        env = dict(os.environ)
        env["OMP_NUM_THREADS"] = str(threads)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "-c", code], cwd=repo, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        return float(r.stdout.split("MPIXS")[1].strip().split()[0])

    t1 = run(1)
    tn = run(ncpu)
    print(f"host scaling: 1T {t1:.1f} -> {ncpu}T {tn:.1f} Mpix/s "
          f"({tn / t1:.2f}x)")
    assert tn > 1.3 * t1, (t1, tn)
