"""Sharded-execution tests on the 8-virtual-device CPU mesh (SURVEY.md §4.8:
sharded vs single-device results must match to tolerance without hardware)."""

import numpy as np
import pytest

from ssim_tpu import compute_ssim, engine
from ssim_tpu.parallel import (
    default_mesh,
    make_mesh,
    mean_ssim_sharded,
    ssim_batch_sharded,
    ssim_spatial_sharded,
)

from conftest import random_pair


@pytest.fixture(scope="module")
def mesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (set XLA_FLAGS=--xla_force_host_platform_device_count=8)")
    return default_mesh("data", 8)


def test_batch_sharded_matches_single(rng, mesh8):
    pairs = [random_pair(rng, 64, 96) for _ in range(8)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    row_sums, _ = ssim_batch_sharded(a, b, mesh8)
    scores = engine.finalize_mean(np.asarray(row_sums), 64 * 96)
    for i in range(8):
        single = compute_ssim(a[i], b[i], impl="xla")
        assert scores[i] == pytest.approx(single, abs=1e-7)


def test_batch_sharded_with_map(rng, mesh8):
    pairs = [random_pair(rng, 40, 64) for _ in range(8)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    row_sums, maps = ssim_batch_sharded(a, b, mesh8, with_map=True)
    assert maps.shape == (8, 40, 64)
    _, want_map = compute_ssim(a[3], b[3], with_map=True, impl="xla")
    assert np.abs(np.asarray(maps[3]) - want_map).max() < 5e-6


def test_mean_ssim_psum(rng, mesh8):
    pairs = [random_pair(rng, 48, 64) for _ in range(8)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    got = float(mean_ssim_sharded(a, b, mesh8))
    want = np.mean([compute_ssim(a[i], b[i], impl="xla") for i in range(8)])
    assert got == pytest.approx(want, abs=1e-6)


def test_spatial_sharded_matches_single(rng):
    """Row-sharded huge-image path: halo exchange must reproduce the
    unsharded result (interior shard boundaries use real neighbor rows)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh((4,), ("space",))
    a, b = random_pair(rng, 4 * 50, 96)  # H=200 divisible by 4
    row_sums, smap = ssim_spatial_sharded(a, b, mesh, with_map=True)
    got = engine.finalize_mean(np.asarray(row_sums), 200 * 96)
    want, want_map = compute_ssim(a, b, with_map=True, impl="xla")
    assert float(got) == pytest.approx(want, abs=1e-7)
    assert np.abs(np.asarray(smap) - want_map).max() < 5e-6


def test_spatial_small_shards(rng):
    """Shard height of exactly radius rows still works (halo == shard)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh((8,), ("space",))
    a, b = random_pair(rng, 8 * 8, 64)
    row_sums, _ = ssim_spatial_sharded(a, b, mesh)
    got = engine.finalize_mean(np.asarray(row_sums), 64 * 64)
    want = compute_ssim(a, b, impl="xla")
    assert float(got) == pytest.approx(want, abs=1e-7)


def test_batch_sharded_pallas_impl(rng, mesh8):
    """The dispatch-chosen per-shard path inside shard_map matches the
    unsharded engine (the XLA formulation on the CPU mesh, the fused
    kernel on GPUs)."""
    pairs = [random_pair(rng, 48, 80) for _ in range(8)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])
    partials, _ = ssim_batch_sharded(a, b, mesh8, impl="auto")
    scores = engine.finalize_mean(np.asarray(partials), 48 * 80)
    for i in range(8):
        single = compute_ssim(a[i], b[i], impl="auto")
        assert scores[i] == pytest.approx(single, abs=1e-7)


@pytest.mark.parametrize("h", [102, 53, 201])
def test_spatial_arbitrary_height(rng, h):
    """Heights that don't divide the mesh are padded internally with
    edge-replicated rows (identical to the clamp-to-edge border rule) and
    the outputs sliced back — the reference handles arbitrary geometry via
    ragged tiles (src/ssim.cpp:227-239), we must too."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh((4,), ("space",))
    a, b = random_pair(rng, h, 64)
    row_sums, smap = ssim_spatial_sharded(a, b, mesh, with_map=True)
    assert row_sums.shape == (h,) and smap.shape == (h, 64)
    got = engine.finalize_mean(np.asarray(row_sums), h * 64)
    want, want_map = compute_ssim(a, b, with_map=True, impl="xla")
    assert float(got) == pytest.approx(want, abs=1e-7)
    assert np.abs(np.asarray(smap) - want_map).max() < 5e-6


def test_spatial_tiny_height(rng):
    """More shards than H/radius: internal padding keeps every shard at
    least radius rows tall so one-neighbor halo exchange still suffices."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh((8,), ("space",))
    a, b = random_pair(rng, 12, 64)  # 12 rows over 8 shards
    row_sums, _ = ssim_spatial_sharded(a, b, mesh)
    got = engine.finalize_mean(np.asarray(row_sums), 12 * 64)
    want = compute_ssim(a, b, impl="xla")
    assert float(got) == pytest.approx(want, abs=1e-7)


@pytest.mark.parametrize("h", [200, 53])
def test_spatial_pallas_matches_unsharded(rng, h):
    """Spatial sharding through the dispatch-chosen impl: halo rows travel
    between shards (ppermute) and each shard's band matches the
    unsharded result — the analogue of the reference's tile grid x
    thread pool composition (src/ssim.cpp:902-926)."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh((4,), ("space",))
    a, b = random_pair(rng, h, 96)
    row_sums, smap = ssim_spatial_sharded(a, b, mesh, with_map=True, impl="auto")
    assert row_sums.shape == (h,) and smap.shape == (h, 96)
    got = engine.finalize_mean(np.asarray(row_sums), h * 96)
    want, want_map = compute_ssim(a, b, with_map=True, impl="auto")
    assert float(got) == pytest.approx(want, abs=1e-6)
    assert np.abs(np.asarray(smap) - want_map).max() < 1e-5


def test_spatial_pallas_wide_mxu_mode(rng):
    """Spatial sharding of a wide image (w = 640) over 8 shards must
    match the unsharded engine."""
    import jax

    from ssim_tpu.parallel.mesh import make_mesh
    from ssim_tpu.parallel.spatial import ssim_spatial_sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh((8,), ("space",))
    h, w = 96, 640
    a, b = random_pair(rng, h, w)
    row_sums, _ = ssim_spatial_sharded(a, b, mesh, impl="auto")
    got = float(np.asarray(row_sums, np.float64).sum() / (h * w))
    want = compute_ssim(a, b, impl="auto")
    assert got == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize(
    "n_shards,h", [(1, 60), (2, 120), (4, 120), (8, 160), (8, 80)]
)
def test_grad_spatial_sharded_matches_unsharded(rng, n_shards, h):
    """The sharded backward returns the exact global gradients: every
    shard count (incl. the hs == 2*RADIUS minimum at (8, 80)) must match
    jax.grad of the unsharded XLA formulation — edge shards exercise the
    clamp replicas, interior shards the cross-boundary halo terms."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.parallel import ssim_grad_spatial_sharded

    w = 96
    a = rng.random((h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)
    ws = 1.0 / (h * w)
    ga, gb = jax.grad(
        lambda x, y: ws * jnp.sum(ssim_parts_xla(x, y, data_range=1.0)[0]),
        argnums=(0, 1),
    )(jnp.asarray(a), jnp.asarray(b))
    mesh = make_mesh((n_shards,), ("space",))
    da, db = ssim_grad_spatial_sharded(a, b, mesh, w_s=ws, data_range=1.0)
    scale = float(jnp.abs(ga).max())
    assert float(jnp.abs(da - ga).max()) <= 3e-5 * scale
    assert float(jnp.abs(db - gb).max()) <= 3e-5 * scale


def test_grad_spatial_sharded_traced_cotangent(rng):
    """w_s may be a traced scalar (a loss cotangent): the whole sharded
    backward works under jit, and scaling w_s scales the gradients."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.parallel import ssim_grad_spatial_sharded

    h, w = 80, 64
    a = rng.random((h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)
    mesh = make_mesh((4,), ("space",))

    @jax.jit
    def run(ws):
        return ssim_grad_spatial_sharded(a, b, mesh, w_s=ws, data_range=1.0)

    da1, _ = run(jnp.float32(1.0))
    da3, _ = run(jnp.float32(3.0))
    np.testing.assert_allclose(
        np.asarray(da3), 3.0 * np.asarray(da1), rtol=1e-5,
        atol=1e-5 * float(np.abs(np.asarray(da1)).max()),  # f32 floor for ~0 entries
    )


def test_grad_spatial_sharded_rejects_bad_geometry(rng):
    from ssim_tpu.errors import InvalidArgumentError  # noqa: F401
    from ssim_tpu.parallel import ssim_grad_spatial_sharded

    mesh = make_mesh((4,), ("space",))
    f32 = np.float32
    ok = rng.random((80, 64)).astype(f32)
    with pytest.raises(ValueError, match="divide"):
        ssim_grad_spatial_sharded(ok[:79], ok[:79], mesh)
    with pytest.raises(ValueError, match="divide"):  # 40/4 = 10 rows < 2r is
        ssim_grad_spatial_sharded(ok[:36], ok[:36], mesh)  # 9 rows: too thin
    with pytest.raises(ValueError, match="float32"):
        u8 = (ok * 255).astype(np.uint8)
        ssim_grad_spatial_sharded(u8, u8, mesh)
    with pytest.raises(ValueError, match="pair"):
        ssim_grad_spatial_sharded(ok[None, None], ok[None, None], mesh)
    with pytest.raises(ValueError, match="batch_axis"):
        ssim_grad_spatial_sharded(ok, ok, mesh, batch_axis="space")
    with pytest.raises(ValueError, match="scalar"):
        ssim_grad_spatial_sharded(
            ok[None], ok[None], mesh, w_s=np.ones((1,), np.float32)
        )


def test_spatial_pallas_float_pair(rng):
    """float32 pairs under spatial sharding match the unsharded XLA
    value."""
    import jax.numpy as jnp

    from ssim_tpu.ops.ssim_xla import ssim_parts_xla

    h, w = 96, 640
    a = rng.random((h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)
    mesh = make_mesh((4,), ("space",))
    row_sums, smap = ssim_spatial_sharded(
        a, b, mesh, data_range=1.0, with_map=True, impl="auto"
    )
    want = float(jnp.sum(
        ssim_parts_xla(jnp.asarray(a), jnp.asarray(b), data_range=1.0)[0]
    )) / (h * w)
    got = float(np.asarray(row_sums, np.float64).sum()) / (h * w)
    assert got == pytest.approx(want, abs=2e-6)
    assert smap.shape == (h, w)


def test_mean_ssim_spatial_differentiable(rng):
    """mean_ssim_spatial: sharded forward and its autodiff backward;
    value and gradient match the unsharded XLA formulation."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.parallel import mean_ssim_spatial

    h, w = 120, 96
    a = rng.random((h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)
    mesh = make_mesh((4,), ("space",))
    val = float(mean_ssim_spatial(a, b, mesh, data_range=1.0, impl="auto"))
    want = float(jnp.sum(ssim_parts_xla(
        jnp.asarray(a), jnp.asarray(b), data_range=1.0)[0]) / (h * w))
    assert val == pytest.approx(want, abs=1e-6)

    loss = lambda x: 1.0 - mean_ssim_spatial(
        x, b, mesh, data_range=1.0, impl="auto")
    ga = jax.grad(loss)(jnp.asarray(a))
    gx = jax.grad(lambda x: 1.0 - jnp.sum(ssim_parts_xla(
        x, jnp.asarray(b), data_range=1.0)[0]) / (h * w))(jnp.asarray(a))
    scale = float(jnp.abs(gx).max())
    assert float(jnp.abs(ga - gx).max()) <= 3e-5 * scale

    # a height that does not divide the mesh: padded forward, autodiff
    a9 = a[:117]
    b9 = b[:117]
    g9 = jax.grad(lambda x: 1.0 - mean_ssim_spatial(
        x, b9, mesh, data_range=1.0, impl="auto"))(jnp.asarray(a9))
    assert bool(jnp.isfinite(g9).all())


def test_mean_ssim_spatial_batched_2d_mesh(rng):
    """(B, H, W) batch on a 2-D data x space mesh: batch sharded over
    'data', rows over 'space'; value and gradient match unsharded XLA
    autodiff. Also covers the
    replicated-batch form (batch_axis=None) and the u8 batched forward."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.parallel import mean_ssim_spatial

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    B, h, w = 4, 80, 64
    a = rng.random((B, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.06, a.shape), 0, 1).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "space"))

    val = float(mean_ssim_spatial(a, b, mesh, axis="space",
                                  batch_axis="data", data_range=1.0,
                                  impl="auto"))
    want = float(jnp.sum(ssim_parts_xla(
        jnp.asarray(a), jnp.asarray(b), data_range=1.0)[0]) / (B * h * w))
    assert val == pytest.approx(want, abs=1e-6)

    gx = jax.grad(lambda x: 1.0 - jnp.sum(ssim_parts_xla(
        x, jnp.asarray(b), data_range=1.0)[0]) / (B * h * w))(jnp.asarray(a))
    scale = float(jnp.abs(gx).max())
    ga = jax.grad(lambda x: 1.0 - mean_ssim_spatial(
        x, b, mesh, axis="space", batch_axis="data", data_range=1.0,
        impl="auto"))(jnp.asarray(a))
    assert float(jnp.abs(ga - gx).max()) <= 3e-5 * scale

    mesh1 = make_mesh((4,), ("space",))
    ga2 = jax.grad(lambda x: 1.0 - mean_ssim_spatial(
        x, b, mesh1, data_range=1.0, impl="auto"))(jnp.asarray(a))
    assert float(jnp.abs(ga2 - gx).max()) <= 3e-5 * scale

    u8a = (a * 255).astype(np.uint8)
    u8b = (b * 255).astype(np.uint8)
    v8 = float(mean_ssim_spatial(u8a, u8b, mesh, axis="space",
                                 batch_axis="data"))
    assert 0.0 < v8 <= 1.0

    with pytest.raises(ValueError, match="batch_axis"):
        mean_ssim_spatial(a[0], b[0], mesh, axis="space", batch_axis="data")


def test_mean_ssim_sharded_custom_window(rng, mesh8):
    """The custom-window extension rides the batch-DP layer: sigma/k1/k2
    and a custom radius per shard must match the unsharded engine."""
    pairs = [random_pair(rng, 48, 64) for _ in range(8)]
    a = np.stack([p[0] for p in pairs])
    b = np.stack([p[1] for p in pairs])

    got = float(mean_ssim_sharded(a, b, mesh8, sigma=2.0, k1=0.02, k2=0.05))
    want = np.mean(
        [compute_ssim(a[i], b[i], sigma=2.0, k1=0.02, k2=0.05) for i in range(8)]
    )
    assert got == pytest.approx(want, abs=2e-6)

    got_r = float(mean_ssim_sharded(a, b, mesh8, radius=3))
    want_r = np.mean([compute_ssim(a[i], b[i], radius=3) for i in range(8)])
    assert got_r == pytest.approx(want_r, abs=2e-6)


def test_spatial_sharded_custom_window(rng, mesh8):
    """sigma/k1/k2 through the spatial layer: forward (per shard with
    halo rows) and the sharded backward."""
    import jax
    import jax.numpy as jnp

    space = make_mesh((8,), ("space",))
    a, b = random_pair(rng, 160, 96)
    kw = dict(sigma=2.0, k1=0.02, k2=0.05)

    row_sums, _ = ssim_spatial_sharded(a, b, space, impl="auto", **kw)
    got = engine.finalize_mean(np.asarray(row_sums), 160 * 96)
    want = compute_ssim(a, b, **kw)
    assert got == pytest.approx(want, abs=2e-6)

    # Custom radius rides the XLA route with radius-deep halos.
    row_sums_r, _ = ssim_spatial_sharded(a, b, space, radius=3, impl="xla")
    got_r = engine.finalize_mean(np.asarray(row_sums_r), 160 * 96)
    assert got_r == pytest.approx(compute_ssim(a, b, radius=3), abs=2e-6)

    # ... and a radius whose halo is deeper than the default window's.
    row_sums_f, _ = ssim_spatial_sharded(a, b, space, radius=9, sigma=3.0,
                                         impl="auto")
    got_f = engine.finalize_mean(np.asarray(row_sums_f), 160 * 96)
    assert got_f == pytest.approx(
        compute_ssim(a, b, radius=9, sigma=3.0), abs=2e-6
    )

    from ssim_tpu.parallel import mean_ssim_spatial

    af = jnp.asarray(a, jnp.float32)
    bf = jnp.asarray(b, jnp.float32)
    ga = jax.grad(
        lambda x: mean_ssim_spatial(x, bf, space, **kw)
    )(af)
    from ssim_tpu.ops.ssim_xla import ssim_parts_xla

    ga_x = jax.grad(
        lambda x: jnp.sum(ssim_parts_xla(x, bf, **kw)[0]) / (160 * 96)
    )(af)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ga_x), atol=2e-7)

    # Custom radius through the sharded backward (the halo depth
    # follows the window).
    ga_r = jax.grad(
        lambda x: mean_ssim_spatial(x, bf, space, radius=8, sigma=2.5)
    )(af)
    ga_rx = jax.grad(
        lambda x: jnp.sum(
            ssim_parts_xla(x, bf, radius=8, sigma=2.5)[0]
        ) / (160 * 96)
    )(af)
    np.testing.assert_allclose(np.asarray(ga_r), np.asarray(ga_rx), atol=2e-7)


def test_batched_mean_ssim_spatial_honors_xla_impl(rng, mesh8):
    """The batched branch takes impl='xla': the XLA formulation per shard,
    differentiable by ordinary autodiff through the ppermute."""
    import jax
    import jax.numpy as jnp

    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.parallel import mean_ssim_spatial

    space = make_mesh((4,), ("space",))
    pairs = [random_pair(rng, 80, 64) for _ in range(3)]
    a = np.stack([p[0] for p in pairs]).astype(np.float32)
    b = np.stack([p[1] for p in pairs]).astype(np.float32)
    af, bf = jnp.asarray(a), jnp.asarray(b)
    n = a.size

    got = float(mean_ssim_spatial(af, bf, space, impl="xla"))
    want = float(jnp.sum(ssim_parts_xla(af, bf)[0]) / n)
    assert got == pytest.approx(want, abs=1e-6)

    ga = jax.grad(lambda x: mean_ssim_spatial(x, bf, space, impl="xla"))(af)
    gx = jax.grad(lambda x: jnp.sum(ssim_parts_xla(x, bf)[0]) / n)(af)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gx), atol=1e-7)
