"""Batch image-pair loading for high-throughput evaluation.

The reference is a single-pair library; its CLI decodes two files per
process (src/ssim-cli.cpp:261-271). A production deployment on an accelerator
instead streams batches: this loader decodes image pairs with a thread pool
(decode is the host-side bottleneck at multi-Gpix/s device throughput),
groups them by resolution (XLA shapes are static), and yields stacked
uint8 batches ready for `compute_ssim` / `ssim_batch_sharded`.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .imageio import load_image, luminance_bt601


def _to_gray(arr: np.ndarray, policy: str) -> np.ndarray:
    if policy.startswith("channel:"):
        ch = int(policy.split(":", 1)[1])
        nch = 1 if arr.ndim == 2 else arr.shape[2]
        if ch >= nch:
            # Same contract as the single-pair CLI (cli.py): asking for a
            # channel the image doesn't have is an error, not a silent
            # fallback to the gray plane.
            raise ValueError(
                f"Cannot compute SSIM for channel {ch}, images have only "
                f"{nch} channels"
            )
        return arr if arr.ndim == 2 else arr[:, :, ch]
    if arr.ndim == 2:
        return arr
    if policy == "luminance":
        return luminance_bt601(arr)
    raise ValueError(f"unknown channel policy {policy!r} (luminance | channel:N)")


def _decode_pair(pair, channel_policy):
    """Decode + channel-reduce one (path_a, path_b) -> (name, a, b).
    Shared by load_pairs and stream_batched_pairs (one copy of the
    decode/validate logic)."""
    pa, pb = pair
    a = _to_gray(load_image(pa), channel_policy)
    b = _to_gray(load_image(pb), channel_policy)
    if a.shape != b.shape:
        raise ValueError(f"size mismatch: {pa} {a.shape} vs {pb} {b.shape}")
    return os.path.basename(pa), a, b


def load_pairs(
    pairs: Sequence[Tuple[str, str]],
    *,
    channel_policy: str = "luminance",
    num_threads: int = 8,
) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Decode image pairs concurrently -> [(name, a, b)] single-channel u8."""
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(lambda p: _decode_pair(p, channel_policy), pairs))


def batched_pairs(
    pairs: Sequence[Tuple[str, str]],
    *,
    batch_size: int = 8,
    channel_policy: str = "luminance",
    num_threads: int = 8,
) -> Iterator[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Yield (names, a_batch, b_batch) with a/b stacked (B, H, W) uint8.

    Pairs are grouped by resolution (one compiled kernel per shape); the
    final group of each resolution may be smaller than batch_size.
    """
    loaded = load_pairs(pairs, channel_policy=channel_policy, num_threads=num_threads)
    by_shape = {}
    for name, a, b in loaded:
        by_shape.setdefault(a.shape, []).append((name, a, b))
    for shape, items in by_shape.items():
        for i in range(0, len(items), batch_size):
            chunk = items[i : i + batch_size]
            names = [c[0] for c in chunk]
            a = np.stack([c[1] for c in chunk])
            b = np.stack([c[2] for c in chunk])
            yield names, a, b


#: stream_batched_pairs flushes its oldest partial group early once this
#: many frames are buffered across groups (keeps memory bounded even when
#: every pair has a distinct resolution — partial batches just recompile
#: at a smaller leading dim, they don't change results).
_MAX_BUFFERED_FACTOR = 4


def stream_batched_pairs(
    pairs: Sequence[Tuple[str, str]],
    *,
    batch_size: int = 8,
    channel_policy: str = "luminance",
    num_threads: int = 8,
    prefetch: int = 2,
) -> Iterator[Tuple[List[str], np.ndarray, np.ndarray]]:
    """Streaming `batched_pairs`: bounded memory, decode-ahead.

    `batched_pairs` decodes the WHOLE list before yielding anything —
    fine for suites, wrong for production streams (a 100k-pair job
    would hold every decoded frame in RAM). This variant keeps at most
    `prefetch * batch_size` decodes in flight ahead of the consumer, so
    host-side decode (the bottleneck at multi-Gpix/s device throughput)
    overlaps the device compute of the previous batch. Pairs are grouped
    by resolution on the fly (XLA shapes are static); a group's batch is
    yielded as soon as it fills. Memory stays bounded even on streams
    where every pair has a unique resolution: once more than
    `_MAX_BUFFERED_FACTOR * batch_size` frames are buffered across
    partial groups, the oldest group is flushed early as a smaller
    batch. Remaining partial groups flush at the end (order follows each
    group's most recent (re-)creation, not strict first-seen order).
    """
    from collections import OrderedDict, deque

    depth = max(1, prefetch) * batch_size
    max_buffered = _MAX_BUFFERED_FACTOR * batch_size
    by_shape: "OrderedDict[tuple, list]" = OrderedDict()
    buffered = 0

    def drain(items):
        names = [c[0] for c in items]
        return names, np.stack([c[1] for c in items]), np.stack([c[2] for c in items])

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        inflight = deque()
        it = iter(pairs)
        try:
            while True:
                while len(inflight) < depth:
                    try:
                        inflight.append(
                            ex.submit(_decode_pair, next(it), channel_policy)
                        )
                    except StopIteration:
                        break
                if not inflight:
                    break
                name, a, b = inflight.popleft().result()
                group = by_shape.setdefault(a.shape, [])
                group.append((name, a, b))
                buffered += 1
                if len(group) >= batch_size:
                    yield drain(group)
                    buffered -= len(group)
                    del by_shape[a.shape]
                elif buffered > max_buffered:
                    # Bound memory on heterogeneous streams: flush the
                    # oldest partial group as a smaller batch.
                    shape, items = next(iter(by_shape.items()))
                    yield drain(items)
                    buffered -= len(items)
                    del by_shape[shape]
        finally:
            # Don't leak threads: cancel queued decodes (their errors, if
            # any, are discarded) and let the executor join running ones.
            # Only the already-popped future's exception propagates.
            for f in inflight:
                f.cancel()
    for items in by_shape.values():
        yield drain(items)


def evaluate_directory(
    dir_a: str,
    dir_b: str,
    *,
    batch_size: int = 8,
    channel_policy: str = "luminance",
    impl="auto",
) -> List[Tuple[str, float]]:
    """SSIM for every same-named image in two directories, batched.

    Returns [(filename, ssim)] sorted by filename.
    """
    from .. import engine

    names = sorted(
        f for f in os.listdir(dir_a)
        if os.path.isfile(os.path.join(dir_a, f))
        and os.path.isfile(os.path.join(dir_b, f))
        and f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".tga"))
    )
    pairs = [(os.path.join(dir_a, f), os.path.join(dir_b, f)) for f in names]
    results = []
    for batch_names, a, b in stream_batched_pairs(
        pairs, batch_size=batch_size, channel_policy=channel_policy
    ):
        scores, _ = engine.compute(a, b, impl=impl)
        scores = np.atleast_1d(scores)
        results.extend(zip(batch_names, (float(s) for s in scores)))
    return sorted(results)
