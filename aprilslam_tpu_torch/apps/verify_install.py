"""Installation verifier (port of ``aprilslam_tpu/apps/verify_install.py``).

Checks the dependencies, the CUDA device, that nvcc builds the CCL kernel,
the family codebooks and the default scene, and runs a functional smoke
test: render a known tag on the card, detect it, assert the id. ``--cpu``
runs the smoke on the CPU and reports the device and the kernel build as
skipped. Without a GPU and without ``--cpu`` it exits 1.

    python -m aprilslam_tpu_torch.apps.verify_install [--cpu]
"""

from __future__ import annotations

import argparse
import importlib
import sys

GREEN, RED, YELLOW, RESET = "\033[92m", "\033[91m", "\033[93m", "\033[0m"


def check(name, fn):
    try:
        detail = fn()
        print(f"{GREEN}[ok]{RESET} {name}" + (f" — {detail}" if detail else ""))
        return True
    except Exception as e:  # noqa: BLE001 - report anything
        print(f"{RED}[FAIL]{RESET} {name}: {type(e).__name__}: {e}")
        return False


def skip(name, why):
    print(f"{YELLOW}[skip]{RESET} {name} — {why}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="verify the aprilslam_tpu_torch installation")
    p.add_argument("--cpu", action="store_true", help="run the smoke test on the CPU")
    args = p.parse_args(argv)

    results = []

    def dep(mod):
        m = importlib.import_module(mod)
        return getattr(m, "__version__", "")

    for mod in ["torch", "numpy", "scipy"]:
        results.append(check(f"dependency {mod}", lambda m=mod: dep(m)))
    for mod in ["cv2", "matplotlib", "PIL"]:
        ok = check(f"optional {mod}", lambda m=mod: dep(m))
        if not ok:
            print(f"{YELLOW}     (optional: real-camera/viz paths degrade gracefully){RESET}")

    import torch

    dev = "cpu" if args.cpu else "cuda"
    if args.cpu:
        skip("CUDA device", "--cpu")
        skip("CCL kernel build (nvcc, sm_90a)", "--cpu")
    else:
        def device_ok():
            from aprilslam_tpu_torch.device import resolve_device

            resolve_device("cuda")
            return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, CUDA {torch.version.cuda}"

        def kernel_ok():
            from aprilslam_tpu_torch.ops.ccl import build_ccl

            path, seconds = build_ccl()
            return f"{path.name} ({'built in %.1f s' % seconds if seconds else 'cached'})"

        results.append(check("CUDA device", device_ok))
        results.append(check("CCL kernel build (nvcc, sm_90a)", kernel_ok))

    def families_ok():
        from aprilslam_tpu_torch.families import get_family

        f36 = get_family("tag36h11")
        f41 = get_family("tagStandard41h12")
        assert f36.n_codes == 587 and f41.n_codes >= 5
        return f"tag36h11 x{f36.n_codes}, tagStandard41h12 x{f41.n_codes}"

    results.append(check("tag family codebooks", families_ok))

    def scene_ok():
        from aprilslam_tpu_torch.sim import SceneConfig

        cfg = SceneConfig.from_file()
        return f"{len(cfg.tags)} tags, {cfg.display_size}"

    results.append(check("default scene config", scene_ok))

    def functional_ok():
        import numpy as np

        from aprilslam_tpu_torch.detect import DetectorParams, TagDetector
        from aprilslam_tpu_torch.geometry import PinholeCamera
        from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors

        cfg = SceneConfig.from_file()
        cam = PinholeCamera.from_fov(256, 256, cfg.fov_y)
        scene = scene_tensors(cfg, device=dev)
        zeros = np.zeros((1, 3), np.float32)
        frames = render_frames(scene, zeros, zeros, cam.inv_matrix, 256, 256, 1, device=dev)
        out = TagDetector(cfg.family, DetectorParams(quad_decimate=1), device=dev).detect(frames)
        ids = out.ids[0][out.valid[0]].cpu().tolist()
        assert 0 in ids, f"tag 0 not detected ({ids})"
        return f"detected tags {ids} on {dev}"

    results.append(check("functional render+detect smoke test", functional_ok))

    n_fail = results.count(False)
    print(
        f"\n{len(results) - n_fail}/{len(results)} required checks passed"
        + (f" — {RED}{n_fail} FAILED{RESET}" if n_fail else f" {GREEN}all good{RESET}")
    )
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
