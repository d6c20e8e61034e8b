"""Image I/O and channel policies.

Parity with the reference CLI's I/O layer (src/ssim-cli.cpp):
- image loading (reference uses stb_image, :87-105; we use PIL). NOTE:
  JPEG decoders differ legitimately in IDCT rounding, so PIL-decoded JPEG
  pixels can differ by ±1 from stb's — the test suite accounts for this.
- BT.601 luminance conversion with the same fixed-point arithmetic
  (src/ssim-cli.cpp:158-186): y = (r*19595 + g*38470 + b*7471 + 32768) >> 16.
- SSIM-map export as PNG/BMP/TGA (u8 quantization clamp(v,0)*255,
  src/ssim-cli.cpp:341-342) or PFM (raw float32, bottom-up, little-endian
  scale -1.0, src/ssim-cli.cpp:355-375).
"""

import os
import struct
from typing import Optional

import numpy as np


def _pil_image():
    """PIL.Image, imported on first use: only image-file I/O needs it
    (the `cli` extra), never the library's compute path."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "reading and writing image files needs Pillow; install it "
            "with: pip install 'ssim-tpu[cli]'"
        ) from None
    return Image


def load_image(path: str, channels: Optional[int] = None) -> np.ndarray:
    """Load an image as uint8 (H, W) or (H, W, C), like stbi_load with
    desired_channels=0 (src/ssim-cli.cpp:92-104)."""
    img = _pil_image().open(path)
    # Match stb: keep native channel count; no alpha premultiply.
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if channels is not None:
        if channels == 1 and arr.ndim == 3:
            arr = luminance_bt601(arr)
        elif channels == 3 and arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
    return arr


def luminance_bt601(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luminance, bit-exact with the reference CLI's fixed-point
    conversion (src/ssim-cli.cpp:158-186)."""
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise ValueError(f"need (H, W, >=3) RGB, got {rgb.shape}")
    r = rgb[:, :, 0].astype(np.uint32)
    g = rgb[:, :, 1].astype(np.uint32)
    b = rgb[:, :, 2].astype(np.uint32)
    y = (r * 19595 + g * 38470 + b * 7471 + 32768) // 65536
    return y.astype(np.uint8)


def quantize_map(ssim_map: np.ndarray) -> np.ndarray:
    """u8 quantization of an SSIM map: clamp negatives to 0, scale by 255,
    TRUNCATE (not round) — bit parity with the reference CLI's
    static_cast<uint8_t>(max(0,v)*255) (src/ssim-cli.cpp:341-342)."""
    return np.minimum(np.maximum(ssim_map, 0.0) * 255.0, 255.0).astype(np.uint8)


def _save_pfm(path: str, data: np.ndarray) -> None:
    """PFM float dump: bottom-up rows, little-endian (scale -1.0), matching
    the reference's writer (src/ssim-cli.cpp:355-375)."""
    data = np.asarray(data, dtype="<f4")
    if data.ndim == 2:
        header = b"Pf\n"
        h, w = data.shape
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF\n"
        h, w = data.shape[:2]
    else:
        raise ValueError(f"PFM supports 1 or 3 channels, got shape {data.shape}")
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(data[::-1]).tobytes())


def load_pfm(path: str) -> np.ndarray:
    """Read back a PFM written by `_save_pfm` (or the reference CLI)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"not a PFM file: {magic!r}")
        w, h = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if magic == b"PF" else 1)
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dtype)
    shape = (h, w, 3) if magic == b"PF" else (h, w)
    return data.reshape(shape)[::-1].copy()


def _save_tga(path: str, gray_or_rgb: np.ndarray) -> None:
    """Minimal uncompressed TGA writer (u8 gray or RGB), parity with
    stbi_write_tga output shape (src/ssim-cli.cpp:349)."""
    arr = np.asarray(gray_or_rgb, dtype=np.uint8)
    if arr.ndim == 2:
        h, w = arr.shape
        imgtype, depth = 3, 8  # grayscale
        payload = arr
    else:
        h, w, c = arr.shape
        if c != 3:
            raise ValueError("TGA writer supports gray or RGB")
        imgtype, depth = 2, 24
        payload = arr[:, :, ::-1]  # BGR
    header = struct.pack(
        "<BBBHHBHHHHBB", 0, 0, imgtype, 0, 0, 0, 0, 0, w, h, depth, 0x20
    )  # 0x20: top-left origin
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(payload).tobytes())


def save_map(path: str, ssim_map: np.ndarray) -> None:
    """Export an SSIM map, format chosen by extension — parity with the
    reference CLI's map export (src/ssim-cli.cpp:298-377):
    .pfm = raw float; .png/.bmp/.tga = u8 quantized."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        _save_pfm(path, ssim_map)
        return
    q = quantize_map(ssim_map)
    if ext == ".tga":
        _save_tga(path, q)
        return
    if ext in (".png", ".bmp"):
        Image = _pil_image()
        if q.ndim == 3 and q.shape[2] == 2:
            img = Image.fromarray(q, mode="LA")  # gray+alpha maps
        else:
            img = Image.fromarray(q)
        img.save(path)
        return
    raise ValueError(f"unsupported map format {ext!r} (png/bmp/tga/pfm)")
