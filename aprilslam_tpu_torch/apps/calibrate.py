"""Calibration CLI (port of ``aprilslam_tpu/apps/calibrate.py``).

``capture`` grabs checkerboard images from a camera; ``solve`` detects
corners (OpenCV) and runs the Zhang calibration of ``calib/``, writing the
``.npz`` artifact and the per-image quality report (``failed_images.txt``).
``--device`` is ``cuda`` (the default: raises without a GPU, never falls
back) or ``cpu``.

    python -m aprilslam_tpu_torch.apps.calibrate solve --images 'shots/*.png'
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Checkerboard camera calibration")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="execution device (cuda raises when no GPU is present)")
    sub = p.add_subparsers(dest="cmd", required=True)

    cap = sub.add_parser("capture", help="capture calibration images from a camera")
    cap.add_argument("--source", default="0")
    cap.add_argument("--out-dir", default="assets/calibration_images")
    cap.add_argument("--count", type=int, default=15)
    cap.add_argument("--interval", type=float, default=1.0)

    sol = sub.add_parser("solve", help="calibrate from captured images")
    sol.add_argument("--images", default="assets/calibration_images/*.jpg")
    sol.add_argument("--cols", type=int, default=10)
    sol.add_argument("--rows", type=int, default=7)
    sol.add_argument("--square-mm", type=float, default=25.0)
    sol.add_argument("--out", default="data/calibration/camera_calibration_parameters.npz")
    sol.add_argument("--report-dir", default="data/logs")

    args = p.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("calibrate")

    import cv2

    if args.cmd == "capture":
        import time

        os.makedirs(args.out_dir, exist_ok=True)
        src = args.source if not args.source.isdigit() else int(args.source)
        cap_dev = cv2.VideoCapture(src)
        if not cap_dev.isOpened():
            log.error("camera open failed")
            return 2
        for i in range(args.count):
            ok, frame = cap_dev.read()
            if not ok:
                break
            path = os.path.join(args.out_dir, f"calib_{i:03d}.jpg")
            cv2.imwrite(path, frame)
            log.info(f"captured {path}")
            time.sleep(args.interval)
        cap_dev.release()
        return 0

    from ..calib import board_points, calibrate_camera, find_checkerboard_corners

    paths = sorted(glob.glob(args.images))
    if not paths:
        log.error(f"no images match {args.images}")
        return 2
    images = [cv2.imread(p0) for p0 in paths]
    pts, oks = find_checkerboard_corners(images, args.cols, args.rows)
    failed = [p0 for p0, ok in zip(paths, oks) if not ok]
    log.info(f"corners found in {len(pts)}/{len(paths)} images")
    if failed:
        os.makedirs(args.report_dir, exist_ok=True)
        with open(os.path.join(args.report_dir, "failed_images.txt"), "w") as f:
            f.write("\n".join(failed))
        log.info(f"{len(failed)} failures listed in failed_images.txt")
    if len(pts) < 3:
        log.error("need at least 3 usable views")
        return 2

    obj = board_points(args.cols, args.rows, args.square_mm)
    res = calibrate_camera(obj, pts, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    res.save_npz(args.out)
    log.info(f"camera matrix:\n{np.round(res.camera_matrix, 2)}")
    log.info(f"distortion: {np.round(res.dist_coeffs, 5)}")
    log.info(f"mean reprojection error: {res.mean_reprojection_error:.3f} px "
             f"-> {res.quality}")
    for p0, e in zip([p1 for p1, ok in zip(paths, oks) if ok], res.per_view_errors):
        log.info(f"  {os.path.basename(p0)}: {e:.3f} px")
    log.info(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
