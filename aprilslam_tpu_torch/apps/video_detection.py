"""Camera / video-file detection app (port of
``aprilslam_tpu/apps/video_detection.py``): load the ``.npz`` intrinsics,
open a capture source (device id with 1, 2 fallback, or a file path), detect
-> pose -> console 6-DOF report (and an optional overlay), rolling FPS.

Frames are buffered into batches and detected together; each batch goes to
the device in one copy, and each output field comes back in one copy, from
which the per-tag report (Euler angles included) is computed on the host.
As in the JAX app, frames that do not fill a last batch are not detected.
``*.y4m`` files are read by the native C++ reader (``runtime/``), with no
OpenCV; cv2 is imported only for another source or for ``--display``.
``--device`` is ``cuda`` (the default: raises without a GPU, never falls
back) or ``cpu``.

    python -m aprilslam_tpu_torch.apps.video_detection --source clip.y4m --batch 8
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np


def load_camera_calibration(path: str):
    """Load the .npz written by the calibration app: (K (3, 3), dist) float32,
    ``dist`` in the shape it was saved in ((1, 5) from the calibration app)."""
    z = np.load(path)
    K = z["camera_matrix"]
    dist = z["dist_coeffs"]
    return K.astype(np.float32), dist.astype(np.float32)


class _Y4MCapture:
    """``cv2.VideoCapture``-like shim over the native Y4M reader
    (``runtime/video_io.cpp``): frames come out (H, W) uint8 grayscale,
    what the detector consumes."""

    def __init__(self, path: str):
        from ..runtime import Y4MReader

        self._r = Y4MReader(path)

    def read(self):
        f = self._r.read()
        return (f is not None), f

    def release(self):
        self._r.close()


def initialize_camera(source, width=640, height=480, fps=30):
    """Open a capture, trying device ids 1 and 2 after the one asked for.

    ``*.y4m`` files use the native C++ reader; everything else (camera
    devices, other containers) goes through ``cv2.VideoCapture``."""
    if isinstance(source, str) and source.lower().endswith(".y4m"):
        return _Y4MCapture(source), source

    import cv2

    candidates = [source] if isinstance(source, str) else [source, 1, 2]
    for cand in candidates:
        cap = cv2.VideoCapture(cand)
        if cap.isOpened():
            if not isinstance(cand, str):
                cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
                cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
                cap.set(cv2.CAP_PROP_FPS, fps)
            return cap, cand
        cap.release()
    raise RuntimeError(f"Could not open any capture source from {candidates}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="AprilTag detection on camera/video")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="execution device (cuda raises when no GPU is present)")
    p.add_argument("--source", default="0", help="device id or video file path")
    p.add_argument("--calibration", default="data/calibration/camera_calibration_parameters.npz")
    p.add_argument("--family", default="tagStandard41h12")
    p.add_argument("--tag-size", type=float, default=0.06, help="metres")
    p.add_argument("--batch", type=int, default=4, help="frames per device batch")
    p.add_argument("--max-frames", type=int, default=0, help="stop after N frames (0 = endless)")
    p.add_argument("--display", action="store_true", help="cv2 window overlay")
    p.add_argument("--decimate", type=int, default=2)
    args = p.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("video")

    import torch

    from ..detect import DetectorParams, TagDetector
    from ..geometry import matrix_to_euler_zyx
    from ..pose import poses_from_detections

    cv2 = None
    if args.display:
        import cv2

    if os.path.exists(args.calibration):
        K, dist = load_camera_calibration(args.calibration)
        log.info(f"Loaded calibration from {args.calibration}")
    else:
        log.warning(f"No calibration at {args.calibration}; using a default 640x480 guess")
        K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)
        dist = np.zeros(5, np.float32)

    source = args.source if not args.source.isdigit() else int(args.source)
    cap, used = initialize_camera(source)
    log.info(f"Capture open on {used}")

    detector = TagDetector(args.family, DetectorParams(quad_decimate=args.decimate,
                                                       min_cluster_pts=12), device=dev)
    Kt = torch.as_tensor(K, device=dev)
    # Corners are undistorted inside PnP (geometry.undistort_pixels);
    # all-zero coefficients skip it.
    distt = torch.as_tensor(dist, device=dev) if np.any(dist) else None

    frames_buf = []
    n_frames = 0
    t0 = time.time()
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames_buf.append(frame)
            n_frames += 1
            if len(frames_buf) == args.batch:
                det = detector.detect(torch.from_numpy(np.stack(frames_buf)).to(dev))
                T, okp, _rms, _seed, _alt = poses_from_detections(det, Kt, args.tag_size,
                                                                  dist_coeffs=distt)
                T, okp, ids, corners = (x.cpu() for x in (T, okp, det.ids, det.corners))
                eul = np.degrees(matrix_to_euler_zyx(T[..., :3, :3]).numpy())
                Tn, okp, ids, corners = T.numpy(), okp.numpy(), ids.numpy(), corners.numpy()
                for b in range(args.batch):
                    for d in range(ids.shape[1]):
                        if not okp[b, d]:
                            continue
                        tv = Tn[b, d, :3, 3]
                        e = eul[b, d]
                        log.info(
                            f"tag {ids[b, d]}: dist {np.linalg.norm(tv):.3f} m  "
                            f"xyz [{tv[0]:+.3f} {tv[1]:+.3f} {tv[2]:+.3f}]  "
                            f"rpy [{e[0]:+6.1f} {e[1]:+6.1f} {e[2]:+6.1f}]"
                        )
                    if args.display:
                        img = frames_buf[b]
                        for d in range(ids.shape[1]):
                            if not okp[b, d]:
                                continue
                            c = corners[b, d].astype(int)
                            for i in range(4):
                                cv2.line(img, tuple(c[i]), tuple(c[(i + 1) % 4]), (0, 255, 0), 2)
                            cv2.putText(img, f"id {ids[b, d]}", tuple(c[3]),
                                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 165, 255), 2)
                        cv2.imshow("aprilslam-torch", img)
                        if cv2.waitKey(1) in (27, ord("q")):
                            raise KeyboardInterrupt
                frames_buf = []
                if n_frames % 30 < args.batch:
                    fps = n_frames / (time.time() - t0)
                    log.info(f"[{n_frames} frames, {fps:.1f} fps]")
            if args.max_frames and n_frames >= args.max_frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        cap.release()
        if args.display:
            cv2.destroyAllWindows()
    log.info(f"Processed {n_frames} frames in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
