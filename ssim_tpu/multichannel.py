"""Channel policies for multi-channel images.

Parity with the reference CLI's channel handling (src/ssim-cli.cpp:130-213):
- per-channel SSIM + average (the default, :200-209),
- a single selected channel (-0..-3, :137-144),
- BT.601 luminance of RGB (-y, :158-186; bit-exact fixed-point conversion
  in utils.imageio.luminance_bt601).

Device note: per-channel computation is just a batch — channels are
stacked on the leading axis and one batched device call computes all of
them (the reference loops channels serially through the whole engine).
"""

from typing import List, NamedTuple, Optional

import numpy as np

from . import engine
from .errors import InvalidArgumentError


class ChannelResult(NamedTuple):
    per_channel: List[float]
    average: float
    maps: Optional[np.ndarray]  # (C, H, W) f32 or None


def _chw(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return img[None]
    if img.ndim == 3:
        return np.moveaxis(img, -1, 0)  # interleaved (H, W, C) -> (C, H, W)
    raise InvalidArgumentError(f"expected (H, W) or (H, W, C) image, got {img.shape}")


def compute_ssim_channels(
    a,
    b,
    *,
    channel: Optional[int] = None,
    luminance: bool = False,
    with_map: bool = False,
    impl="auto",
    data_range: float = 255.0,
    downsample=None,
    accuracy=None,
    radius: int = 5,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> ChannelResult:
    """Multi-channel SSIM with the reference CLI's channel policy.

    downsample: None / "auto" / int k — the Wang box-mean prefilter
    extension (see engine.compute); applied per channel after the
    channel policy, so -y pools the luminance plane.
    accuracy: None/"standard" or "relaxed" (see engine.compute).
    radius/sigma/k1/k2: the custom-window extension (see engine.compute)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise InvalidArgumentError(f"image shapes differ: {a.shape} vs {b.shape}")

    if luminance and (a.ndim == 3 and a.shape[2] >= 3):
        from .utils import luminance_bt601

        a_stack = luminance_bt601(a)[None]
        b_stack = luminance_bt601(b)[None]
    elif luminance:
        # Reference: <3 channels + -y degrades to channel 0 (src/ssim-cli.cpp:132-133).
        a_stack = _chw(a)[:1]
        b_stack = _chw(b)[:1]
    else:
        a_stack = _chw(a)
        b_stack = _chw(b)
        if channel is not None:
            if not (0 <= channel < a_stack.shape[0]):
                raise InvalidArgumentError(
                    f"channel {channel} out of range for {a_stack.shape[0]} channels"
                )
            a_stack = a_stack[channel : channel + 1]
            b_stack = b_stack[channel : channel + 1]

    scores, maps = engine.compute(
        a_stack, b_stack, with_map=with_map, impl=impl, data_range=data_range,
        downsample=downsample, accuracy=accuracy, radius=radius, sigma=sigma,
        k1=k1, k2=k2,
    )
    scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
    per_channel = [float(s) for s in scores]
    return ChannelResult(per_channel, float(scores.mean()), maps)
