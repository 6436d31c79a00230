"""ASCII dump of the clean-miss tag region (frame 1, tag index 1) of the
port's render and threshold (port of ``tools/probe_ascii.py``).

Prints the oracle corners of that tag (behind tag 0 from frame 1's pose),
the scene's tag ids and positions, then the gray levels and the trinary
map (``.`` unknown, ``#`` white, ``o`` black) over rows 215-299 (every
second) and columns 0-99 of ``tools/probe_robustness_torch.py``'s clean
512x512 frame 1, thresholded as the detector does (tile 4, min contrast
0.08).

    python3 tools/probe_ascii_torch.py                # on the card; exits 1 without one
    python3 tools/probe_ascii_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_robustness_torch import _np, scenarios  # noqa: E402

RAMP = " .:-=+*#%@"
SYMBOLS = {-1: ".", 0: "o", 1: "#"}
ROWS = range(215, 300, 2)
COLS = range(0, 100)


def ascii_dump(gray: np.ndarray, trinary: np.ndarray, rows=ROWS, cols=COLS) -> list:
    """Lines of the gray levels (ten-step ramp) then of the trinary map of
    one (H, W) frame over ``rows`` x ``cols``."""
    lines = [f"{y:3d} " + "".join(RAMP[min(9, int(gray[y, x] * 9.999))] for x in cols) for y in rows]
    lines.append("=== trinary (.=unknown, #=white, o=black) ===")
    lines += [f"{y:3d} " + "".join(SYMBOLS[int(trinary[y, x])] for x in cols) for y in rows]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    from aprilslam_tpu_torch.detect.threshold import adaptive_threshold_with_levels, to_grayscale

    sc = next(scenarios(args.device))  # the clean control
    gray = to_grayscale(sc.frames)
    trinary = adaptive_threshold_with_levels(gray, tile=4, min_contrast=0.08)[0]
    print("tag GT corners:", sc.gt_uv[1, 1])
    print("scene tag ids:", _np(sc.scene.tag_ids), " positions:\n", _np(sc.scene.tag_pos))
    print("\n".join(ascii_dump(_np(gray[1]), _np(trinary[1]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
