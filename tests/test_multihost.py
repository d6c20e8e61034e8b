"""Multi-process (multi-host/DCN analogue) tests.

Two coordinated JAX processes, each with 4 virtual CPU devices, form a
global 8-device mesh and run the sharded mean-SSIM; the result must
match the single-process computation. This exercises the real
`jax.distributed` wiring (coordination service + cross-process
collectives) that a multi-host cluster uses — the strongest multi-host
evidence available on a single machine (SURVEY §4.8's simulation
strategy, one level up from virtual devices).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_pair

_WORKER = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

from ssim_tpu.parallel import multihost
from ssim_tpu.parallel.batch import mean_ssim_sharded

port, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

mesh = multihost.global_mesh((8,), ("data",))

# A mesh that excludes a whole process must raise the targeted error
# (review finding: it used to fail opaquely inside distribute_batch).
try:
    multihost.global_mesh((4,), ("data",))
except ValueError as e:
    assert "every process" in str(e), e
else:
    raise SystemExit("expected ValueError for a mesh excluding process 1")

# Each process holds only ITS half of the batch (4 images), seeded so
# the union is the same 8-image batch the single-process check uses.
rng = np.random.default_rng(1000 + pid)
a_local = rng.integers(0, 256, (4, 48, 64), dtype=np.uint8)
noise = rng.normal(0, 12, a_local.shape)
b_local = np.clip(a_local.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)

a = multihost.distribute_batch(a_local, mesh)
b = multihost.distribute_batch(b_local, mesh)
got = float(mean_ssim_sharded(a, b, mesh, impl="xla"))
print(f"RESULT {pid} {got!r}", flush=True)
"""


def _run_two_process(worker_src):
    """Launch two coordinated workers, return {pid: RESULT value}."""
    # Pick a free port for the coordinator.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker_src, str(port), str(pid)],
            cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        if p.returncode != 0:
            if "distributed" in err and ("not support" in err or "Unimplemented" in err):
                pytest.skip(f"multi-process CPU collectives unavailable: {err[-300:]}")
            pytest.fail(f"worker failed (rc={p.returncode}): {err[-2000:]}")
        outs.append(out)

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, val = line.split(" ", 2)
                results[int(pid)] = float(eval(val))
    assert set(results) == {0, 1}, outs
    return results


def test_two_process_mean_ssim(tmp_path):
    results = _run_two_process(_WORKER)
    # Both processes see the same replicated global mean.
    assert results[0] == pytest.approx(results[1], abs=1e-7)

    # Single-process ground truth over the union batch.
    from ssim_tpu import compute_ssim

    scores = []
    for pid in (0, 1):
        rng = np.random.default_rng(1000 + pid)
        a_local = rng.integers(0, 256, (4, 48, 64), dtype=np.uint8)
        noise = rng.normal(0, 12, a_local.shape)
        b_local = np.clip(
            a_local.astype(np.int32) + noise.astype(np.int32), 0, 255
        ).astype(np.uint8)
        scores.extend(
            compute_ssim(a_local[i], b_local[i], impl="xla") for i in range(4)
        )
    assert results[0] == pytest.approx(float(np.mean(scores)), abs=1e-6)


# What the interpret_kernel fixture (conftest.py) does, for the worker
# processes: impl="pallas" available on the CPU, the fused kernel run by
# the Pallas interpreter.
_INTERPRET_KERNEL = """
import functools
from ssim_tpu import dispatch
import ssim_tpu.ops.ssim_pallas as _kernel
dispatch.backend_platform = lambda: "gpu"
_kernel.ssim_parts_pallas = functools.partial(_kernel.ssim_parts_pallas,
                                              interpret=True)
"""
_PLATFORM_LINE = 'jax.config.update("jax_platforms", "cpu")\n'


def _with_interpret_kernel(worker_src):
    return worker_src.replace(_PLATFORM_LINE,
                              _PLATFORM_LINE + _INTERPRET_KERNEL, 1)


_WORKER_PALLAS_BATCH = _with_interpret_kernel(
    _WORKER.replace('impl="xla"', 'impl="pallas"'))


def test_two_process_mean_ssim_fused_kernel(interpret_kernel):
    """The fused kernel (the Pallas interpreter on the CPU) under real
    cross-process collectives: shard_map + psum spanning two processes,
    with the kernel running per-shard."""
    results = _run_two_process(_WORKER_PALLAS_BATCH)
    assert results[0] == pytest.approx(results[1], abs=1e-7)

    from ssim_tpu import compute_ssim

    scores = []
    for pid in (0, 1):
        rng = np.random.default_rng(1000 + pid)
        a_local = rng.integers(0, 256, (4, 48, 64), dtype=np.uint8)
        noise = rng.normal(0, 12, a_local.shape)
        b_local = np.clip(
            a_local.astype(np.int32) + noise.astype(np.int32), 0, 255
        ).astype(np.uint8)
        scores.extend(
            compute_ssim(a_local[i], b_local[i], impl="pallas") for i in range(4)
        )
    assert results[0] == pytest.approx(float(np.mean(scores)), abs=1e-6)


_WORKER_SPATIAL = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")

from jax.sharding import NamedSharding, PartitionSpec as P
from ssim_tpu.parallel import multihost
from ssim_tpu.parallel.spatial import ssim_spatial_sharded

port, pid = sys.argv[1], int(sys.argv[2])
impl = "IMPL_PLACEHOLDER"
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert len(jax.devices()) == 8

mesh = multihost.global_mesh((8,), ("space",))

# One 96x64 image, identical on both processes (same seed); each process
# contributes its own 48-row half, so the ppermute halo exchange at the
# 48-row boundary crosses the PROCESS boundary over the coordinator's
# collectives (the DCN analogue).
rng = np.random.default_rng(77)
a_full = rng.integers(0, 256, (96, 64), dtype=np.uint8)
noise = rng.normal(0, 12, a_full.shape)
b_full = np.clip(a_full.astype(np.int32) + noise.astype(np.int32), 0, 255).astype(np.uint8)

sharding = NamedSharding(mesh, P("space", None))
a = jax.make_array_from_process_local_data(sharding, a_full[pid * 48 : (pid + 1) * 48])
b = jax.make_array_from_process_local_data(sharding, b_full[pid * 48 : (pid + 1) * 48])
assert a.shape == (96, 64), a.shape

row_sums, _ = ssim_spatial_sharded(a, b, mesh, impl=impl)
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(row_sums)
got = float(total) / (96 * 64)
print(f"RESULT {pid} {got!r}", flush=True)
"""


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_two_process_spatial_sharded(impl, request):
    """Row-sharded single-image SSIM across two processes: the halo
    ppermute at the mid-image shard boundary crosses processes. Both the
    XLA path and the fused kernel (the Pallas interpreter) must agree
    with the single-process score."""
    worker = _WORKER_SPATIAL.replace("IMPL_PLACEHOLDER", impl)
    if impl == "pallas":
        request.getfixturevalue("interpret_kernel")
        worker = _with_interpret_kernel(worker)
    results = _run_two_process(worker)
    assert results[0] == pytest.approx(results[1], abs=1e-7)

    from ssim_tpu import compute_ssim

    rng = np.random.default_rng(77)
    a_full = rng.integers(0, 256, (96, 64), dtype=np.uint8)
    noise = rng.normal(0, 12, a_full.shape)
    b_full = np.clip(
        a_full.astype(np.int32) + noise.astype(np.int32), 0, 255
    ).astype(np.uint8)
    want = compute_ssim(a_full, b_full, impl=impl)
    assert results[0] == pytest.approx(want, abs=2e-6)


_WORKER_SPATIAL_GRAD = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")

from jax.sharding import NamedSharding, PartitionSpec as P
from ssim_tpu.parallel import multihost
from ssim_tpu.parallel.spatial import ssim_grad_spatial_sharded
from ssim_tpu.ops.ssim_xla import ssim_parts_xla

port, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert len(jax.devices()) == 8

mesh = multihost.global_mesh((8,), ("space",))

h, w = 160, 64  # 8 shards x 20 rows (>= 2*RADIUS)
rng = np.random.default_rng(78)
a_full = rng.random((h, w)).astype(np.float32)
b_full = np.clip(a_full + rng.normal(0, 0.06, a_full.shape), 0, 1).astype(np.float32)

sharding = NamedSharding(mesh, P("space", None))
half = h // 2
a = jax.make_array_from_process_local_data(sharding, a_full[pid * half : (pid + 1) * half])
b = jax.make_array_from_process_local_data(sharding, b_full[pid * half : (pid + 1) * half])

ws = 1.0 / (h * w)
da, db = ssim_grad_spatial_sharded(a, b, mesh, w_s=ws, data_range=1.0)

# Unsharded reference, computed locally (both processes hold the full
# image), then laid out with the same sharding for a global comparison.
ga, gb = jax.grad(
    lambda x, y: ws * jnp.sum(ssim_parts_xla(x, y, data_range=1.0)[0]),
    argnums=(0, 1),
)(jnp.asarray(a_full), jnp.asarray(b_full))
ga_s = jax.make_array_from_process_local_data(
    sharding, np.asarray(ga)[pid * half : (pid + 1) * half])
gb_s = jax.make_array_from_process_local_data(
    sharding, np.asarray(gb)[pid * half : (pid + 1) * half])

rep = NamedSharding(mesh, P())
err = jax.jit(
    lambda x, y, u, v: jnp.maximum(jnp.abs(x - u).max(), jnp.abs(y - v).max()),
    out_shardings=rep,
)(da, db, ga_s, gb_s)
scale = float(np.abs(np.asarray(ga)).max())
print(f"RESULT {pid} {float(err) / scale!r}", flush=True)
"""


def test_two_process_spatial_grad():
    """The sharded fused backward across two processes: halo exchange AND
    the edge-fold/mask logic run under real cross-process collectives;
    the gradients must match unsharded autodiff (relative error printed
    by each worker)."""
    results = _run_two_process(_WORKER_SPATIAL_GRAD)
    assert results[0] == pytest.approx(results[1], abs=1e-9)
    assert results[0] <= 3e-5, results
