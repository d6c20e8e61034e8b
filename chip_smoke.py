"""Smoke test of the main path on the GPU.

    python chip_smoke.py          # one card: phases 1-7
    python chip_smoke.py --four   # four cards: the sharded paths only

Drives the public entry points at real sizes on seeded, correlated u8
pairs (ssim_tpu.testing.devicebench.correlated_pair) and checks each
result against the repo's references: the float64 NumPy oracle
(ssim_tpu/reference.py) or the same formulation in float64 on the card.
Every phase prints one line: its name, the shapes, the largest error next
to its bound, a device-loop rate in Mpix/s (a diagnostic, not a claim)
and the card. A failed bound or any exception exits non-zero. The last
line of standard output is one JSON object naming the device.

Exits 1 without a result when JAX finds no GPU. Runs in one process.
"""

import json
import subprocess
import sys
import time

import numpy as np

GLOBAL_TOL = 2e-6  # per-image global score vs the f64 oracle (README)
MAP_TOL = 1e-3  # per-pixel map vs the f64 oracle (README)
GRAD_REL_TOL = 3e-5  # gradient vs f64 autodiff, relative to max |g|
MS_TOL = 1e-5  # MS-SSIM vs the f64 pyramid
F64_TOL = 1e-9  # precision="f64" vs the f64 oracle
IMPL_TOL = 2e-6  # impl="pallas" vs impl="xla", global score


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


class Smoke:
    def __init__(self, card_name: str):
        self.card = card_name
        self.failed = []

    def report(self, phase, shapes, checks, rate, extra=""):
        """checks: [(what, max error, bound)]; rate in Mpix/s or None."""
        ok = all(bool(np.isfinite(e)) and e <= t for _, e, t in checks)
        if not ok:
            self.failed.append(phase)
        errs = ", ".join(f"{what} max err {e:.3e} <= {t:.0e}"
                         for what, e, t in checks)
        rate_s = "rate n/a" if rate is None else f"{rate:.1f} Mpix/s"
        print(f"[{'ok' if ok else 'FAIL'}] {phase} | {shapes} | {errs} | "
              f"{rate_s} | {self.card}" + (f" | {extra}" if extra else ""),
              flush=True)


def fmt(*shapes):
    return " ".join("x".join(str(d) for d in s) for s in shapes)


def single_card(smoke: Smoke):
    import jax
    import jax.numpy as jnp

    import ssim_tpu as st
    from ssim_tpu import engine, reference
    from ssim_tpu.api import _device_finalize
    from ssim_tpu.dispatch import Implementation, select_impl
    from ssim_tpu.models.msssim import MS_SSIM_WEIGHTS, _ms_xla_forward
    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.testing.devicebench import (
        correlated_pair,
        device_rate,
        make_fn,
    )

    kernel = select_impl("auto") == Implementation.PALLAS
    print(f"auto impl: {select_impl('auto').value}", flush=True)

    def parts_rate(a, b, impl="auto", with_map=False):
        return device_rate(make_fn(impl, with_map), jax.device_put(a),
                           jax.device_put(b), iters=32)

    def maxdiff(x, y):
        return float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))

    # Phase 2: host arrays in, score and map out.
    a4k, b4k = correlated_pair((4, 2160, 3840), seed=1)
    want4k, want4k_map = reference.compute_ssim(a4k, b4k, with_map=True)
    smoke.report("2 compute_ssim", fmt(a4k.shape),
                 [("global", maxdiff(st.compute_ssim(a4k, b4k), want4k),
                   GLOBAL_TOL)], parts_rate(a4k, b4k))
    got, got_map = st.compute_ssim_map(a4k, b4k)
    smoke.report("2 compute_ssim_map", fmt(a4k.shape),
                 [("global", maxdiff(got, want4k), GLOBAL_TOL),
                  ("map", maxdiff(got_map, want4k_map), MAP_TOL)],
                 parts_rate(a4k, b4k, with_map=True))
    del want4k_map, got_map

    # Phase 3: device arrays in.
    a8, b8 = correlated_pair((8, 1080, 1920), seed=2)
    want8, want8_map = reference.compute_ssim(a8, b8, with_map=True)
    da8, db8 = jax.device_put(a8), jax.device_put(b8)
    smoke.report("3 ssim u8", fmt(a8.shape),
                 [("global", maxdiff(st.ssim(da8, db8), want8), GLOBAL_TOL)],
                 device_rate(lambda x, y: st.ssim(x, y), da8, db8, iters=32))
    fa8 = da8.astype(jnp.float32)
    fb8 = db8.astype(jnp.float32)
    score, smap = st.ssim_and_map(fa8, fb8, data_range=255.0)
    smoke.report("3 ssim_and_map f32", fmt(a8.shape),
                 [("global", maxdiff(score, want8), GLOBAL_TOL),
                  ("map", maxdiff(smap, want8_map), MAP_TOL)],
                 device_rate(lambda x, y: st.ssim_and_map(
                     x, y, data_range=255.0), fa8, fb8, iters=32))
    del want8_map, smap
    # The jitted df32 finalize against the host f64 finalize: <= 1 ulp.
    partials = make_fn("auto")(da8, db8)[0]
    dev = np.asarray(_device_finalize(partials, 1080 * 1920), np.float64)
    host = engine.finalize_mean(np.asarray(partials), 1080 * 1920)
    ulp = np.spacing(np.abs(host).astype(np.float32)).astype(np.float64)
    smoke.report("3 device finalize vs host f64", fmt(a8.shape),
                 [("ulp", float(np.max(np.abs(dev - host) / ulp)), 1.0)],
                 None)
    at, bt = correlated_pair((1024, 128, 128), seed=3)
    want_t, _ = reference.compute_ssim(at, bt)
    dat, dbt = jax.device_put(at), jax.device_put(bt)
    smoke.report("3 ssim thumbnails", fmt(at.shape),
                 [("global", maxdiff(st.ssim(dat, dbt), want_t), GLOBAL_TOL)],
                 device_rate(lambda x, y: st.ssim(x, y), dat, dbt, iters=32))

    # Phase 4: gradient of the training loss vs f64 autodiff on the card.
    ag, bg = correlated_pair((4, 1080, 1920), seed=4, dtype=np.float32)
    ag, bg = ag / np.float32(255.0), bg / np.float32(255.0)
    dag, dbg = jax.device_put(ag), jax.device_put(bg)
    grad = jax.jit(jax.grad(lambda x, y: st.ssim_loss(x, y)))
    g = np.asarray(grad(dag, dbg))
    with jax.enable_x64(True):
        n = ag.size
        g64 = np.asarray(jax.jit(jax.grad(
            lambda x, y: 1.0 - jnp.sum(ssim_parts_xla(
                x, y, data_range=1.0, dtype=jnp.float64)[0]) / n
        ))(jnp.asarray(ag, jnp.float64), jnp.asarray(bg, jnp.float64)))
    smoke.report("4 grad ssim_loss", fmt(ag.shape),
                 [("relative", maxdiff(g, g64) / float(np.abs(g64).max()),
                   GRAD_REL_TOL)],
                 device_rate(grad, dag, dbg, iters=16))
    del g, g64

    # Phase 5: MS-SSIM vs the same pyramid in float64 on the card.
    am, bm = correlated_pair((4, 1080, 1920), seed=5)
    dam, dbm = jax.device_put(am), jax.device_put(bm)
    got_ms = np.asarray(st.ms_ssim(dam, dbm))
    with jax.enable_x64(True):
        want_ms = np.asarray(jax.jit(
            lambda x, y: _ms_xla_forward(x, y, 255.0, MS_SSIM_WEIGHTS,
                                         dtype=jnp.float64)
        )(jnp.asarray(am), jnp.asarray(bm)))
    smoke.report("5 ms_ssim", fmt(am.shape),
                 [("score", maxdiff(got_ms, want_ms), MS_TOL)],
                 device_rate(lambda x, y: st.ms_ssim(x, y), dam, dbm,
                             iters=16))

    # Phase 6: precision="f64" on the device.
    a6, b6 = correlated_pair((2160, 3840), seed=6)
    for label, x, y, dr in (("u8", a6, b6, 255.0),
                            ("f32", a6.astype(np.float32) / np.float32(255),
                             b6.astype(np.float32) / np.float32(255), 1.0)):
        want, _ = reference.compute_ssim(x, y, data_range=dr)
        got = st.compute_ssim(x, y, precision="f64", data_range=dr)
        with jax.enable_x64(True):
            rate = device_rate(
                lambda p, q: ssim_parts_xla(p, q, data_range=dr,
                                            dtype=jnp.float64)[0],
                jax.device_put(x), jax.device_put(y), iters=16)
        smoke.report(f"6 precision=f64 {label}", fmt(x.shape),
                     [("global", maxdiff(got, want), F64_TOL)], rate)

    # Phase 7: the fused kernel against the plain XLA formulation.
    if not kernel:
        return
    smoke.report("7 compute_ssim pallas vs xla", fmt(a4k.shape),
                 [("global", maxdiff(st.compute_ssim(a4k, b4k, impl="pallas"),
                                     st.compute_ssim(a4k, b4k, impl="xla")),
                   IMPL_TOL)],
                 parts_rate(a4k, b4k, "pallas"),
                 f"xla {parts_rate(a4k, b4k, 'xla'):.1f} Mpix/s")
    for label, x, y in (("ssim", da8, db8), ("ssim thumbnails", dat, dbt)):
        rates = {impl: device_rate(lambda p, q: st.ssim(p, q, impl=impl),
                                   x, y, iters=32)
                 for impl in ("pallas", "xla")}
        smoke.report(f"7 {label} pallas vs xla", fmt(x.shape),
                     [("global", maxdiff(st.ssim(x, y, impl="pallas"),
                                         st.ssim(x, y, impl="xla")),
                       IMPL_TOL)],
                     rates["pallas"], f"xla {rates['xla']:.1f} Mpix/s")


def four_cards(smoke: Smoke):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import ssim_tpu as st
    from ssim_tpu import engine
    from ssim_tpu.ops.ssim_xla import ssim_parts_xla
    from ssim_tpu.parallel import (
        mean_ssim_sharded,
        mean_ssim_spatial,
        ssim_batch_sharded,
        ssim_spatial_sharded,
    )
    from ssim_tpu.testing.devicebench import correlated_pair, device_rate

    devs = jax.devices()[:4]
    one = devs[0]
    data = Mesh(np.array(devs), ("data",))
    space = Mesh(np.array(devs), ("space",))
    grid = Mesh(np.array(devs).reshape(2, 2), ("data", "space"))

    def placed(x):
        return f"devices {sorted(d.id for d in x.sharding.device_set)}"

    def maxdiff(x, y):
        return float(jnp.max(jnp.abs(jax.device_put(x, one).astype(
            jnp.float32) - jax.device_put(y, one).astype(jnp.float32))))

    # (a) batch data parallelism vs single-card ssim.
    a, b = correlated_pair((16, 1080, 1920), seed=11)
    want = np.asarray(st.ssim(jax.device_put(a, one),
                              jax.device_put(b, one)), np.float64)
    sa = jax.device_put(a, NamedSharding(data, P("data")))
    sb = jax.device_put(b, NamedSharding(data, P("data")))
    partials, _ = ssim_batch_sharded(sa, sb, data)
    got = engine.finalize_mean(np.asarray(partials), a.shape[-1] * a.shape[-2])
    smoke.report("4a ssim_batch_sharded", fmt(a.shape),
                 [("global", float(np.abs(got - want).max()), GLOBAL_TOL)],
                 device_rate(lambda x, y: ssim_batch_sharded(x, y, data)[0],
                             sa, sb, iters=16), placed(partials))
    mean = mean_ssim_sharded(sa, sb, data)
    smoke.report("4a mean_ssim_sharded", fmt(a.shape),
                 [("mean", abs(float(mean) - float(want.mean())),
                   GLOBAL_TOL)], None, placed(mean))

    # (b) one 16K image, rows over four cards, vs the unsharded result.
    a, b = correlated_pair((8640, 15360), seed=12)
    want_rows, want_map = ssim_parts_xla(jax.device_put(a, one),
                                         jax.device_put(b, one),
                                         with_map=True)
    want = float(np.asarray(want_rows, np.float64).sum()) / a.size
    sa = jax.device_put(a, NamedSharding(space, P("space", None)))
    sb = jax.device_put(b, NamedSharding(space, P("space", None)))
    rows, smap = ssim_spatial_sharded(sa, sb, space, with_map=True)
    got = float(np.asarray(rows, np.float64).sum()) / a.size
    smoke.report("4b ssim_spatial_sharded", fmt(a.shape),
                 [("global", abs(got - want), GLOBAL_TOL),
                  ("map", maxdiff(smap, want_map), MAP_TOL)],
                 device_rate(lambda x, y: ssim_spatial_sharded(
                     x, y, space)[0], sa, sb, iters=8), placed(smap))
    del want_map, smap

    # (c) gradient of mean_ssim_spatial on 4 and on 2x2 cards.
    for label, mesh, shape, kw in (
        ("space 4", space, (2160, 3840), {}),
        ("data x space 2x2", grid, (4, 1080, 1920), {"batch_axis": "data"}),
    ):
        x, y = correlated_pair(shape, seed=13, dtype=np.float32)
        x, y = x / np.float32(255), y / np.float32(255)
        n = x.size
        g = jax.jit(jax.grad(lambda p, q: mean_ssim_spatial(
            p, q, mesh, data_range=1.0, **kw)))(x, y)
        g_ref = jax.jit(jax.grad(lambda p, q: jnp.sum(ssim_parts_xla(
            p, q, data_range=1.0)[0]) / n))(
            jax.device_put(x, one), jax.device_put(y, one))
        rel = maxdiff(g, g_ref) / float(jnp.max(jnp.abs(g_ref)))
        smoke.report(f"4c grad mean_ssim_spatial {label}", fmt(shape),
                     [("relative", rel, GRAD_REL_TOL)], None, placed(g))

    # (d) the distributed training dryrun on the cards.
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    smoke.report("4d dryrun_multichip(4)", "mesh 2x2", [], None,
                 f"{time.perf_counter() - t0:.1f} s")


def main(argv):
    four = "--four" in argv[1:]
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    need = 4 if four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1

    from ssim_tpu.config import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smoke = Smoke(card())
    smoke.report("1 device", f"{devs[0].platform} {devs[0].device_kind} "
                 f"x{len(devs)}", [], None)
    t0 = time.perf_counter()
    (four_cards if four else single_card)(smoke)
    print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
