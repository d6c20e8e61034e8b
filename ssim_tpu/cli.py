"""Command-line tool, parity with the reference CLI (src/ssim-cli.cpp).

Usage: python -m ssim_tpu.cli [options] img1 img2 [map]
  -#            compute SSIM only for channel # (0..3)  (src/ssim-cli.cpp:237-245)
  -y            compute SSIM on BT.601 luminance        (src/ssim-cli.cpp:246-247)
  --ms          compute multi-scale SSIM (extension; single channel/luminance)
  --impl=NAME   implementation override (extension; default auto)
  --dir         batch-evaluate two DIRECTORIES of same-named images
                (extension; streaming decode-ahead loader, utils/dataset.py)

Output format matches the reference (src/ssim-cli.cpp:143,197,205-210):
single-channel prints "% 7.4f", per-channel mode prints one line per
channel plus the average. Map export format is chosen by extension:
.bmp/.png/.tga (u8-quantized) or .pfm (raw float), src/ssim-cli.cpp:298-377.
"""

import sys

import numpy as np


def print_help(file=sys.stdout):
    file.write(
        "Usage: ssim-tpu [options] img1 img2 [map]\n"
        "Options:\n"
        "  -#  Compute SSIM only for channel #\n"
        "  -y  Compute SSIM on luminance\n"
        "      For images with <= 2 channels, only channel 0's SSIM will be computed\n"
        "      For images with >= 3 channels, first three channels are converted from RGB to Y\n"
        "  --ms Compute multi-scale SSIM (MS-SSIM) instead of SSIM\n"
        "  --impl=NAME  Force implementation (auto/xla/pallas/reference/host)\n"
        "  --downsample[=auto|K]  Box-mean prefilter (Wang round(min/256)\n"
        "      factor, or explicit K); the map is then pooled-size\n"
        "  --relaxed  Accepted for compatibility; computes at standard\n"
        "      accuracy\n"
        "  --dir  Treat the two paths as DIRECTORIES: batch-evaluate every\n"
        "      same-named image (streaming decode-ahead loader, one\n"
        "      'name: score' line each; -y/-# pick the channel policy)\n"
        "  --batch=N  Batch size for --dir (default 8)\n"
        "  --radius=R --sigma=S --k1=V --k2=V  Custom Gaussian window and\n"
        "      stabilization constants (defaults 5/1.5/0.01/0.03 = the\n"
        "      reference contract; skimage-style extension)\n\n"
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if len(argv) == 1 and argv[0] in ("-h", "--help"):
        print_help(sys.stdout)
        return 0

    only_channel = -1
    luminance = False
    multiscale = False
    impl = "auto"
    downsample = None
    accuracy = None
    dir_mode = False
    batch_size = None  # --dir default 8; rejected outside --dir
    window = {}  # radius/sigma/k1/k2 overrides

    while argv and argv[0].startswith("-"):
        opt = argv.pop(0)
        if opt in ("-0", "-1", "-2", "-3"):
            only_channel = int(opt[1])
        elif opt == "-y":
            luminance = True
        elif opt == "--ms":
            multiscale = True
        elif opt == "--dir":
            dir_mode = True
        elif opt.startswith("--batch="):
            try:
                batch_size = int(opt.split("=", 1)[1])
                if batch_size < 1:
                    raise ValueError
            except ValueError:
                sys.stderr.write(f"Bad --batch value: {opt.split('=', 1)[1]}\n")
                return 1
        elif opt.startswith("--impl="):
            impl = opt.split("=", 1)[1]
        elif opt == "--downsample" or opt.startswith("--downsample="):
            val = opt.split("=", 1)[1] if "=" in opt else "auto"
            if val != "auto":
                try:
                    val = int(val)
                except ValueError:
                    sys.stderr.write(f"Bad --downsample value: {val}\n")
                    return 1
            downsample = val
        elif opt == "--relaxed":
            accuracy = "relaxed"
        elif opt.startswith(("--radius=", "--sigma=", "--k1=", "--k2=")):
            name, val = opt[2:].split("=", 1)
            try:
                window[name] = int(val) if name == "radius" else float(val)
            except ValueError:
                sys.stderr.write(f"Bad --{name} value: {val}\n")
                return 1
        else:
            sys.stderr.write(f"Unknown option: {opt}\n")
            return 1

    if len(argv) < 2 or len(argv) > 3:
        print_help(sys.stderr)
        return 1

    if not dir_mode and batch_size is not None:
        # Accepting-and-ignoring would misreport what ran (same
        # convention as --dir rejecting --ms/--downsample).
        sys.stderr.write("--batch only applies to --dir mode\n")
        return 1

    if dir_mode:
        if len(argv) != 2:
            sys.stderr.write("--dir takes exactly two directories\n")
            return 1
        if multiscale or downsample is not None or accuracy is not None or window:
            sys.stderr.write(
                "--dir supports only -y/-#/--impl/--batch options\n"
            )
            return 1
        from .config import enable_compile_cache
        from .utils.dataset import evaluate_directory

        enable_compile_cache()
        # Same precedence as single-pair mode (compute_ssim_channels,
        # reference src/ssim-cli.cpp:132-133): -y wins over -#.
        policy = (
            "luminance"
            if luminance or only_channel < 0
            else f"channel:{only_channel}"
        )
        try:
            results = evaluate_directory(
                argv[0], argv[1], batch_size=batch_size or 8,
                channel_policy=policy, impl=impl,
            )
        except Exception as e:
            sys.stderr.write(f"{e}\n")
            return 1
        if not results:
            sys.stderr.write("no same-named images in the two directories\n")
            return 1
        for name, score in results:
            sys.stdout.write(f"{name}: {score: 7.4f}\n")
        return 0

    img1_path, img2_path = argv[0], argv[1]
    map_path = argv[2] if len(argv) == 3 else None

    from .config import enable_compile_cache
    from .multichannel import compute_ssim_channels
    from .utils import load_image, save_map

    # Each CLI invocation is a fresh process; the persistent compilation
    # cache makes the first-shape compile a one-time cost
    # (SSIM_TPU_COMPILE_CACHE=0 disables).
    enable_compile_cache()

    try:
        img1 = load_image(img1_path)
        img2 = load_image(img2_path)
    except Exception as e:
        sys.stderr.write(f"{e}\n")
        return 1

    if img1.shape[:2] != img2.shape[:2]:
        sys.stderr.write(
            "Images do not have the same dimensions: "
            f"{img1.shape[1]}x{img1.shape[0]} vs {img2.shape[1]}x{img2.shape[0]}\n"
        )
        return 1
    c1 = 1 if img1.ndim == 2 else img1.shape[2]
    c2 = 1 if img2.ndim == 2 else img2.shape[2]
    if c1 != c2:
        sys.stderr.write(f"Images do not have the same number of channels: {c1} vs {c2}\n")
        return 1
    if only_channel >= 0 and only_channel >= c1:
        sys.stderr.write(
            f"Cannot compute SSIM for channel {only_channel}, images have only {c1} channels\n"
        )
        return 1

    if multiscale:
        from .models import compute_ms_ssim
        from .utils import luminance_bt601

        if map_path is not None:
            sys.stderr.write("--ms does not produce a per-pixel map\n")
            return 1
        if downsample is not None:
            # MS-SSIM is already multi-scale; silently ignoring the flag
            # would misreport what was computed.
            sys.stderr.write("--downsample cannot be combined with --ms\n")
            return 1
        if "radius" in window:
            # The MS-SSIM recipe pins the canonical 11x11 window size
            # (Wang 2003); sigma/k1/k2 pass through (torchmetrics-style).
            sys.stderr.write("--radius cannot be combined with --ms\n")
            return 1
        try:
            if img1.ndim == 3 and (luminance or only_channel < 0):
                m1, m2 = luminance_bt601(img1), luminance_bt601(img2)
            elif img1.ndim == 3:
                m1, m2 = img1[:, :, only_channel], img2[:, :, only_channel]
            else:
                m1, m2 = img1, img2
            score = compute_ms_ssim(
                m1, m2, accuracy=accuracy or "standard", **window
            )
        except Exception as e:
            sys.stderr.write(f"{e}\n")
            return 1
        sys.stdout.write(f"{score: 7.4f}\n")
        return 0

    try:
        result = compute_ssim_channels(
            img1,
            img2,
            channel=None if only_channel < 0 else only_channel,
            luminance=luminance,
            with_map=map_path is not None,
            impl=impl,
            downsample=downsample,
            accuracy=accuracy,
            **window,
        )
    except Exception as e:
        sys.stderr.write(f"{e}\n")
        return 1

    # The reference prints the bare score only for -# / -y; a 1-channel
    # image without those still goes through the per-channel loop and
    # prints "Channel 0" + "Average" lines (src/ssim-cli.cpp:197-210).
    if only_channel >= 0 or luminance:
        sys.stdout.write(f"{result.per_channel[0]: 7.4f}\n")
    else:
        for c, s in enumerate(result.per_channel):
            sys.stdout.write(f"Channel {c}: {s: 7.4f}\n")
        sys.stdout.write(f"Average  : {result.average: 7.4f}\n")

    if map_path is not None:
        maps = result.maps  # (C, H, W)
        out = maps[0] if maps.shape[0] == 1 else np.moveaxis(maps, 0, -1)
        try:
            save_map(map_path, out)
        except Exception as e:
            sys.stderr.write(f"{e}\n")
            return 1

    return 0


if __name__ == "__main__":
    sys.exit(main())
