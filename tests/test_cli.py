"""CLI parity tests (reference src/ssim-cli.cpp): option surface, output
format, channel policies, map export."""

import os

import numpy as np
import pytest
from PIL import Image

from ssim_tpu import cli, compute_ssim
from ssim_tpu.multichannel import compute_ssim_channels
from ssim_tpu.utils import luminance_bt601
from ssim_tpu.utils.imageio import load_pfm


@pytest.fixture()
def image_pair(tmp_path, rng):
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    noise = rng.normal(0, 10, a.shape).astype(np.int32)
    b = np.clip(a.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    return a, b, pa, pb


def test_help(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "Usage" in out and "-y" in out


def test_no_args_fails(capsys):
    assert cli.main([]) == 1


def test_per_channel_output(image_pair, capsys):
    a, b, pa, pb = image_pair
    assert cli.main(["--impl=xla", pa, pb]) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(lines) == 4  # 3 channels + average (src/ssim-cli.cpp:205-210)
    assert lines[0].startswith("Channel 0:")
    assert lines[3].startswith("Average  :")
    want = compute_ssim(a[:, :, 0], b[:, :, 0], impl="xla")
    assert float(lines[0].split(":")[1]) == pytest.approx(want, abs=5e-5)


def test_single_channel_option(image_pair, capsys):
    a, b, pa, pb = image_pair
    assert cli.main(["-2", "--impl=xla", pa, pb]) == 0
    out = capsys.readouterr().out.strip()
    want = compute_ssim(a[:, :, 2], b[:, :, 2], impl="xla")
    assert float(out) == pytest.approx(want, abs=5e-5)


def test_luminance_option(image_pair, capsys):
    a, b, pa, pb = image_pair
    assert cli.main(["-y", "--impl=xla", pa, pb]) == 0
    out = capsys.readouterr().out.strip()
    want = compute_ssim(luminance_bt601(a), luminance_bt601(b), impl="xla")
    assert float(out) == pytest.approx(want, abs=5e-5)


def test_channel_out_of_range(image_pair, capsys):
    _, _, pa, pb = image_pair
    assert cli.main(["-3", pa, pb]) == 1
    assert "only" in capsys.readouterr().err


def test_dimension_mismatch(tmp_path, rng, capsys):
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    assert cli.main([pa, pb]) == 1
    assert "same dimensions" in capsys.readouterr().err


def test_map_export_pfm(image_pair, tmp_path, capsys):
    a, b, pa, pb = image_pair
    map_path = str(tmp_path / "map.pfm")
    assert cli.main(["-y", "--impl=xla", pa, pb, map_path]) == 0
    m = load_pfm(map_path)
    assert m.shape == (48, 64)
    _, want = compute_ssim(luminance_bt601(a), luminance_bt601(b), with_map=True, impl="xla")
    np.testing.assert_allclose(m, want, atol=1e-6)


def test_map_export_png_interleaved(image_pair, tmp_path, capsys):
    _, _, pa, pb = image_pair
    map_path = str(tmp_path / "map.png")
    assert cli.main(["--impl=xla", pa, pb, map_path]) == 0
    m = np.asarray(Image.open(map_path))
    assert m.shape == (48, 64, 3)  # interleaved per-channel map


def test_multichannel_batched_equals_serial(rng):
    """The batched channel stack must equal per-channel serial calls."""
    a = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    res = compute_ssim_channels(a, b, impl="xla")
    for c in range(3):
        want = compute_ssim(a[:, :, c], b[:, :, c], impl="xla")
        # 1e-8: on an accelerator the batched channel stack fuses/reduces in a
        # different order than the serial calls (measured diff ~1.6e-9).
        assert res.per_channel[c] == pytest.approx(want, abs=1e-8)
    assert res.average == pytest.approx(np.mean(res.per_channel), abs=1e-12)


def test_grayscale_prints_channel_and_average(tmp_path, rng, capsys):
    """1-channel images without -y/-# still go through the per-channel
    loop: "Channel 0" + "Average" lines (src/ssim-cli.cpp:197-210)."""
    a = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
    pa, pb = str(tmp_path / "ga.png"), str(tmp_path / "gb.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    assert cli.main(["--impl=xla", pa, pb]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("Channel 0:")
    assert lines[1].startswith("Average  :")
    want = compute_ssim(a, b, impl="xla")
    assert float(lines[0].split(":")[1]) == pytest.approx(want, abs=5e-5)


def test_quantize_map_truncates_like_reference():
    """u8 map export truncates (static_cast), never rounds
    (src/ssim-cli.cpp:341-342)."""
    from ssim_tpu.utils.imageio import quantize_map

    m = np.array([-0.5, 0.0, 0.00392, 0.0039215, 0.9999, 1.0], np.float32)
    q = quantize_map(m)
    # 0.9999*255 = 254.97 -> 254 (rounding would give 255)
    np.testing.assert_array_equal(q, [0, 0, 0, 0, 254, 255])


def test_pnm_image_loading(tmp_path, rng):
    """stb_image reads binary PNM (P5/P6, src/ssim-cli.cpp via stb); our
    PIL-based loader must cover the same formats."""
    from ssim_tpu.utils import load_image

    gray = rng.integers(0, 256, (12, 16), dtype=np.uint8)
    rgbi = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    p5 = tmp_path / "g.pgm"
    p5.write_bytes(b"P5\n16 12\n255\n" + gray.tobytes())
    p6 = tmp_path / "c.ppm"
    p6.write_bytes(b"P6\n16 12\n255\n" + rgbi.tobytes())
    np.testing.assert_array_equal(load_image(str(p5)), gray)
    np.testing.assert_array_equal(load_image(str(p6)), rgbi)


def test_cli_relaxed_flag(image_pair, capsys):
    """--relaxed computes within the loose tier of the standard score,
    for both single-scale and --ms (where it loosens the wide pyramid
    scales)."""
    a, b, pa, pb = image_pair
    assert cli.main(["-y", "--relaxed", pa, pb]) == 0
    got = float(capsys.readouterr().out.strip())
    want = compute_ssim(luminance_bt601(a), luminance_bt601(b))
    assert got == pytest.approx(want, abs=1e-3)


def test_cli_relaxed_ms(tmp_path, rng, capsys):
    """--relaxed combines with --ms (loosening the wide pyramid scales);
    the image must be large enough for 5 scales."""
    from PIL import Image

    from ssim_tpu.models import compute_ms_ssim

    a = rng.integers(0, 256, (192, 256), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-10, 10, a.shape),
                0, 255).astype(np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    assert cli.main(["--relaxed", "--ms", pa, pb]) == 0
    got_ms = float(capsys.readouterr().out.strip())
    want_ms = compute_ms_ssim(a, b)
    assert got_ms == pytest.approx(want_ms, abs=1e-3)


def test_cli_dir_mode(tmp_path, rng, capsys):
    """--dir batch-evaluates two directories of same-named images via the
    streaming loader, printing one 'name: score' line per pair; option
    conflicts and empty intersections are rejected."""
    from PIL import Image

    da, db = tmp_path / "a", tmp_path / "b"
    da.mkdir(), db.mkdir()
    truths = {}
    for i in range(3):
        img_a = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        img_b = np.clip(img_a.astype(np.int32)
                        + rng.integers(-12, 12, img_a.shape),
                        0, 255).astype(np.uint8)
        name = f"img{i}.png"
        Image.fromarray(img_a).save(da / name)
        Image.fromarray(img_b).save(db / name)
        truths[name] = compute_ssim(luminance_bt601(img_a),
                                    luminance_bt601(img_b))
    assert cli.main(["--dir", "--batch=2", str(da), str(db)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        name, score = line.split(":")
        assert float(score) == pytest.approx(truths[name.strip()], abs=1e-4)

    assert cli.main(["--dir", "--ms", str(da), str(db)]) == 1
    assert "--dir" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["--dir", str(da), str(empty)]) == 1
    assert "no same-named" in capsys.readouterr().err


def test_window_flags(image_pair, capsys):
    """--radius/--sigma/--k1/--k2 thread through to the engine."""
    a, b, pa, pb = image_pair
    assert cli.main(
        ["-0", "--impl=xla", "--radius=3", "--sigma=2.0", "--k1=0.02",
         "--k2=0.05", pa, pb]
    ) == 0
    out = capsys.readouterr().out.strip()
    want = compute_ssim(
        a[:, :, 0], b[:, :, 0], impl="xla", radius=3, sigma=2.0,
        k1=0.02, k2=0.05,
    )
    assert float(out) == pytest.approx(want, abs=5e-5)


def test_window_flags_bad_value(image_pair, capsys):
    _, _, pa, pb = image_pair
    assert cli.main(["--sigma=abc", pa, pb]) == 1
    assert "Bad --sigma value" in capsys.readouterr().err


def test_window_flags_invalid_param(image_pair, capsys):
    _, _, pa, pb = image_pair
    assert cli.main(["--radius=0", pa, pb]) == 1  # engine validation


def test_window_flags_reject_ms_radius(image_pair, capsys):
    """--ms takes sigma/k1/k2 (torchmetrics-style) but pins the canonical
    11x11 window size."""
    _, _, pa, pb = image_pair
    assert cli.main(["--ms", "--radius=3", pa, pb]) == 1
    assert "--ms" in capsys.readouterr().err
