"""Platform dispatch, routing and the GPU entry scripts, checked on the CPU.

On the CPU the fused kernel is not an implementation: impl="pallas"
raises UnsupportedError and "auto" resolves to XLA. The routing policy,
the jitted df32 finalize, the compile-cache location and the scripts'
refusal to run without a GPU are platform-independent and checked here.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from ssim_tpu import UnsupportedError, compute_ssim, engine
from ssim_tpu.dispatch import Implementation, available_impls, select_impl

from conftest import random_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_auto_resolves_to_xla_on_cpu():
    assert select_impl("auto") == Implementation.XLA
    assert Implementation.PALLAS not in available_impls()


@pytest.mark.parametrize("entry", ["engine", "ssim", "ms_ssim", "batch",
                                   "spatial"])
def test_pallas_impl_unsupported_on_cpu(rng, entry):
    """A forced impl="pallas" is an explicit error off the GPU — never
    the interpreter, never a silent fallback."""
    import jax

    from ssim_tpu import ms_ssim, ssim
    from ssim_tpu.parallel import make_mesh, ssim_batch_sharded
    from ssim_tpu.parallel import ssim_spatial_sharded

    a, b = random_pair(rng, 13, 17)  # a shape no other test traces
    mesh = make_mesh((1,), ("data",))
    calls = {
        "engine": lambda: engine.compute(a, b, impl="pallas"),
        "ssim": lambda: ssim(a, b, impl="pallas"),
        "ms_ssim": lambda: ms_ssim(np.zeros((176, 177), np.uint8),
                                   np.zeros((176, 177), np.uint8),
                                   impl="pallas"),
        "batch": lambda: ssim_batch_sharded(a[None], b[None], mesh,
                                            impl="pallas"),
        "spatial": lambda: ssim_spatial_sharded(
            a, b, make_mesh((1,), ("space",)), impl="pallas"),
    }
    with pytest.raises(UnsupportedError):
        jax.block_until_ready(calls[entry]())


@pytest.mark.parametrize(
    "da,db,radius,routable",
    [
        (np.uint8, np.uint8, 5, True),
        (np.float32, np.float32, 5, True),
        (np.uint16, np.uint16, 5, True),
        (np.float16, np.float16, 5, True),
        (jnp.bfloat16, jnp.bfloat16, 5, True),
        (np.uint8, np.uint8, 16, True),
        (np.uint8, np.uint8, 17, False),
        (np.uint8, np.float32, 5, False),
        (np.int32, np.int32, 5, False),
    ],
)
def test_pallas_routable(da, db, radius, routable):
    from ssim_tpu.ops.routing import pallas_routable

    a = np.zeros((4, 4), da)
    b = np.zeros((4, 4), db)
    assert pallas_routable(a, b, radius) is routable


def test_parts_auto_routes_kernel_and_xla(rng, interpret_kernel):
    """ssim_parts_auto: the kernel (per-tile partials) for routable
    pairs, the XLA path (per-row partials) otherwise; equal scores."""
    from ssim_tpu.ops.routing import ssim_parts_auto

    a, b = random_pair(rng, 70, 40)
    pk, _ = ssim_parts_auto(a, b)
    px, _ = ssim_parts_auto(a.astype(np.int32), b.astype(np.int32))
    assert pk.shape == (2,) and px.shape == (70,)
    assert engine.finalize_mean(np.asarray(pk), a.size) == pytest.approx(
        engine.finalize_mean(np.asarray(px), a.size), abs=5e-7)


@pytest.mark.parametrize("with_map", [False, True])
def test_with_xla_vjp(rng, with_map, interpret_kernel):
    """The kernel primal with the XLA formulation's VJP: equal values,
    equal gradients."""
    import jax

    from ssim_tpu.api import _device_finalize
    from ssim_tpu.ops.routing import with_xla_vjp
    from ssim_tpu.ops.ssim_pallas import ssim_parts_pallas
    from ssim_tpu.ops.ssim_xla import ssim_parts_xla

    a = rng.random((2, 18, 30)).astype(np.float32)
    b = rng.random((2, 18, 30)).astype(np.float32)

    def fwd(parts):
        def f(x, y):
            p, m = parts(x, y, with_map=with_map, data_range=1.0)
            s = _device_finalize(p, 18 * 30)
            return (s, m) if with_map else s
        return f

    f = with_xla_vjp(fwd(ssim_parts_pallas), fwd(ssim_parts_xla))

    def loss(fn):
        def g(x):
            out = fn(x, b)
            return jnp.sum(out[0]) + jnp.sum(out[1] ** 2) if with_map \
                else jnp.sum(out)
        return g

    np.testing.assert_allclose(float(loss(f)(a)),
                               float(loss(fwd(ssim_parts_xla))(a)),
                               rtol=1e-6)
    gk = jax.grad(loss(f))(a)
    gx = jax.grad(loss(fwd(ssim_parts_xla)))(a)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx), atol=1e-7)


@pytest.mark.parametrize("k", [1, 7, 480, 4096])
def test_device_finalize_matches_host_f64(rng, k):
    """The jitted df32 finalize (api._device_finalize) and the host f64
    engine.finalize_mean agree to one f32 ulp of the score."""
    from ssim_tpu.api import _device_finalize

    n = 1920 * 1080
    partials = (rng.random((3, k)) * (n / k)).astype(np.float32)
    dev = np.asarray(_device_finalize(jnp.asarray(partials), n), np.float64)
    host = engine.finalize_mean(partials, n)
    ulp = np.spacing(host.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(dev - host) <= ulp)


def test_spatial_kernel_band_matches_xla(rng, interpret_kernel):
    """The spatial layer's kernel branch (each shard's band through the
    kernel's row_offset mode) matches its XLA branch, map and score, on
    a height that does not divide the mesh."""
    from ssim_tpu.parallel import make_mesh
    from ssim_tpu.parallel.spatial import ssim_spatial_sharded

    mesh = make_mesh((4,), ("space",))
    a, b = random_pair(rng, 53, 70)
    rk, mk = ssim_spatial_sharded(a, b, mesh, with_map=True, impl="pallas")
    rx, mx = ssim_spatial_sharded(a, b, mesh, with_map=True, impl="xla")
    assert rk.shape == (53,) and mk.shape == (53, 70)
    np.testing.assert_allclose(np.asarray(mk), np.asarray(mx), atol=5e-6)
    np.testing.assert_allclose(np.asarray(rk), np.asarray(rx), atol=1e-4)


@pytest.mark.parametrize("radius,n", [(3, 2), (9, 4), (16, 2)])
def test_spatial_kernel_band_custom_radius(rng, radius, n, interpret_kernel):
    """The kernel band mode with halos of other depths, score only."""
    from ssim_tpu.parallel import make_mesh
    from ssim_tpu.parallel.spatial import ssim_spatial_sharded

    mesh = make_mesh((n,), ("space",))
    a, b = random_pair(rng, 70, 50)
    kw = dict(radius=radius, sigma=radius / 3)
    rk, mk = ssim_spatial_sharded(a, b, mesh, impl="pallas", **kw)
    want = compute_ssim(a, b, impl="xla", **kw)
    assert mk is None and rk.shape == (70,)
    assert float(np.asarray(rk, np.float64).sum()) / a.size == \
        pytest.approx(want, abs=2e-6)


def test_spatial_kernel_grad_uses_xla(rng, interpret_kernel):
    """mean_ssim_spatial on the kernel route: value from the kernel,
    gradient from the XLA branch's autodiff."""
    import jax

    from ssim_tpu.parallel import make_mesh, mean_ssim_spatial

    mesh = make_mesh((4,), ("space",))
    a = rng.random((2, 40, 36)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    vk = float(mean_ssim_spatial(a, b, mesh, data_range=1.0, impl="pallas"))
    vx = float(mean_ssim_spatial(a, b, mesh, data_range=1.0, impl="xla"))
    assert vk == pytest.approx(vx, abs=1e-6)
    gk = jax.grad(lambda x: mean_ssim_spatial(x, b, mesh, data_range=1.0,
                                              impl="pallas"))(a)
    gx = jax.grad(lambda x: mean_ssim_spatial(x, b, mesh, data_range=1.0,
                                              impl="xla"))(a)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gx), atol=1e-8)


@pytest.fixture
def restore_cache_config():
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_compile_cache_default_location(monkeypatch, restore_cache_config):
    """Without JAX_COMPILATION_CACHE_DIR the cache lands at the fixed
    <checkout>/.cache/xla_cache."""
    import jax

    from ssim_tpu.config import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("SSIM_TPU_COMPILE_CACHE", raising=False)
    want = os.path.join(REPO, ".cache", "xla_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_env_dir_is_the_only_dir(monkeypatch, tmp_path,
                                               restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and the
    checkout's default directory is not set."""
    import jax

    from ssim_tpu.config import enable_compile_cache

    target = tmp_path / "jaxcache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert enable_compile_cache() == str(target)
    assert jax.config.jax_compilation_cache_dir == str(target)


def _run_script(args, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.update(extra_env or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    """The GPU scripts exit non-zero and print no result without a GPU."""
    r = _run_script([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and "Mpix/s" not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo
    fails without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_dryrun_multichip_refuses_missing_gpus(monkeypatch):
    """On a GPU platform with too few cards the dryrun raises instead of
    respawning on a virtual CPU mesh."""
    import jax

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.remove(REPO)

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.setattr(g, "_respawn_on_virtual_cpu_mesh",
                        lambda n: pytest.fail("respawned on the CPU"))
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        g.dryrun_multichip(4)


@pytest.mark.parametrize("impl", ["auto", "xla", "grad", "grad_xla",
                                  "msssim"])
def test_devicebench_cells_run(impl):
    """Every benchmark cell's device call runs and returns finite values
    on the CPU (the XLA route; the kernel cells run on the card)."""
    import jax

    from ssim_tpu.testing.devicebench import correlated_pair, make_fn

    dtype = np.float32 if impl.startswith("grad") else np.uint8
    shape = (1, 176, 176) if impl == "msssim" else (2, 20, 28)
    a, b = correlated_pair(shape, seed=5, dtype=dtype)
    for leaf in jax.tree.leaves(make_fn(impl)(a, b)):
        assert bool(jnp.isfinite(leaf).all())


def test_bench_cells_cover_kernel_shapes():
    """bench.py pairs the dispatch-chosen forward with XLA at the shapes
    the kernel was kept on, with and without the map, plus the gradient
    and MS-SSIM cells."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    cells = dict(bench.cells())
    shapes = {(c["batch"], c["h"], c["w"]) for c in cells.values()}
    assert {(8, 1080, 1920), (4, 2160, 3840), (1, 4320, 7680),
            (1024, 128, 128)} <= shapes
    for name, c in cells.items():
        if name.startswith("auto_"):
            assert cells["xla_" + name[len("auto_"):]]["impl"] == "xla"
    assert cells["auto_1080_b8_map"]["with_map"]
    assert {"grad_1080_b4", "grad_xla_1080_b4", "msssim_1080_b4"} <= set(cells)


def test_devicebench_rate_runs(rng):
    """The on-device timing loop runs end to end (the number is a CPU
    rate here and means nothing for the card)."""
    from ssim_tpu.testing.devicebench import (
        correlated_pair,
        device_rate,
        make_fn,
    )

    a, b = correlated_pair((2, 24, 32), seed=3)
    assert a.dtype == np.uint8 and not np.array_equal(a, b)
    assert device_rate(make_fn("xla"), a, b, iters=8, reps=1) > 0


def test_cli_needs_pillow_only_for_files(monkeypatch):
    """Without Pillow, image-file I/O raises a clear ImportError naming
    the `cli` extra; the compute path needs no Pillow."""
    import builtins

    from ssim_tpu.utils import imageio

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match=r"ssim-tpu\[cli\]"):
        imageio.load_image("missing.png")
    a = np.zeros((12, 12), np.uint8)
    assert compute_ssim(a, a) == pytest.approx(1.0)
