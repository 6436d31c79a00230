"""Native host runtime (port of ``aprilslam_tpu/runtime/__init__.py``): ctypes
over the port's own copies of ``rasterizer.cpp`` and ``video_io.cpp``.

The library is compiled with g++ on first use, from the sources in the
checkout, into ``build/aprilslam_tpu_torch/runtime_<digest>.so`` beside the
package, and rebuilt when a source changes. A failed build raises with the
compiler's output; nothing falls back to another reader or rasterizer.
Provides:

* :class:`Y4MReader` — Y4M (YUV4MPEG2) luma reader with a C++ prefetch
  thread, the video replay's cv2-free file path;
* :func:`render_frames_native` — synchronous multithreaded CPU rasterizer
  with the conventions of ``sim.render_frames``;
* :class:`FramePipeline` — asynchronous double-buffered frame producer with
  C++ worker threads.

All three are host code and return numpy arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SOURCES = [Path(__file__).resolve().parent / name for name in ("rasterizer.cpp", "video_io.cpp")]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aprilslam_tpu_torch"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def build_runtime() -> tuple[Path, float]:
    """Compile the runtime unless a build of these exact sources exists.

    Returns (shared library path, seconds spent compiling; 0.0 if cached).
    Raises when g++ is missing or the compile fails."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags().encode())  # -march=native: a build fits its own CPU only
    lib_path = BUILD_DIR / f"runtime_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", tmp],
                             capture_output=True, text=True)
    except FileNotFoundError:
        os.unlink(tmp)
        raise RuntimeError("g++ not found: the native runtime cannot be built") from None
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, seconds


def _cpu_flags() -> str:
    """The host CPU's feature flags (Linux), or "" where they cannot be read."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def load_library() -> ctypes.CDLL:
    """The runtime library with its argument types declared (built on first use)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib_path, _ = build_runtime()
                _lib = _declare(ctypes.CDLL(str(lib_path)))
    return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    scene_and_camera = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.asr_render_frames.argtypes = scene_and_camera + [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.asr_render_frames.restype = None
    lib.asr_pipeline_create.argtypes = scene_and_camera + [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.asr_pipeline_create.restype = ctypes.c_void_p
    lib.asr_pipeline_next.argtypes = [ctypes.c_void_p, f32p]
    lib.asr_pipeline_next.restype = ctypes.c_int
    lib.asr_pipeline_destroy.argtypes = [ctypes.c_void_p]
    lib.asr_pipeline_destroy.restype = None
    lib.asr_version.argtypes = []
    lib.asr_version.restype = ctypes.c_int
    lib.vio_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.vio_open.restype = ctypes.c_void_p
    lib.vio_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.vio_next.restype = ctypes.c_int
    lib.vio_close.argtypes = [ctypes.c_void_p]
    lib.vio_close.restype = None
    return lib


class Y4MReader:
    """Native Y4M (YUV4MPEG2) file reader — luma plane only, prefetched by a
    C++ worker thread (``video_io.cpp``).

    Usage::

        with Y4MReader(path) as r:
            frames = r.read_batch(8)   # (n<=8, H, W) uint8, n==0 at EOF
    """

    def __init__(self, path: str):
        self._lib = load_library()
        w, h = ctypes.c_int(), ctypes.c_int()
        fn, fd = ctypes.c_long(), ctypes.c_long()
        self._h = self._lib.vio_open(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                                     ctypes.byref(fn), ctypes.byref(fd))
        if not self._h:
            raise OSError(f"cannot open Y4M stream: {path}")
        self.width = w.value
        self.height = h.value
        self.fps = fn.value / max(fd.value, 1)

    def read(self) -> np.ndarray | None:
        """Next frame as (H, W) uint8, or None at EOF."""
        out = np.empty((self.height, self.width), np.uint8)
        ok = self._lib.vio_next(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out if ok else None

    def read_batch(self, n: int) -> np.ndarray:
        """Up to n frames stacked (k, H, W) uint8; k < n only at EOF."""
        frames = []
        for _ in range(n):
            f = self.read()
            if f is None:
                break
            frames.append(f)
        if not frames:
            return np.empty((0, self.height, self.width), np.uint8)
        return np.stack(frames)

    def close(self) -> None:
        if self._h:
            self._lib.vio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _scene_arrays(scene):
    """Contiguous float32 host copies of the scene's textures and tag poses
    (the scene's tensors may live on the card)."""
    return tuple(
        np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)
        for t in (scene.textures, scene.tag_pos, scene.tag_rot)
    )


def _scene_and_camera_args(scene, camera, tex, tpos, trot):
    return (
        _fp(tex), tex.shape[0], tex.shape[1], _fp(tpos), _fp(trot),
        float(scene.outer_half), float(scene.background), float(scene.near_clip),
        float(scene.far_clip), float(camera.fx), float(camera.fy),
        float(camera.cx), float(camera.cy),
    )


def render_frames_native(
    scene,
    cam_pos: np.ndarray,
    cam_rot: np.ndarray,
    camera,
    height: int,
    width: int,
    supersample: int = 2,
    n_threads: int | None = None,
) -> np.ndarray:
    """CPU rasterizer with the conventions of ``sim.render_frames`` (scene:
    ``SceneTensors`` on any device, camera: ``PinholeCamera``). Returns
    (B, height, width) float32 in [0, 1] as a numpy array."""
    lib = load_library()
    tex, tpos, trot = _scene_arrays(scene)
    cp = np.ascontiguousarray(cam_pos, dtype=np.float32)
    cr = np.ascontiguousarray(cam_rot, dtype=np.float32)
    B = cp.shape[0]
    out = np.empty((B, height, width), dtype=np.float32)
    nt = n_threads or min(os.cpu_count() or 1, B)
    lib.asr_render_frames(*_scene_and_camera_args(scene, camera, tex, tpos, trot),
                          _fp(cp), _fp(cr), B, height, width, int(supersample), int(nt), _fp(out))
    return out


class FramePipeline:
    """Async CPU frame producer: C++ threads render batches ahead of the
    consumer; each batch is a (batch, H, W) float32 numpy array.

    Usage::

        with FramePipeline(scene, cam, traj.positions, traj.rotations,
                           height=H, width=W, batch=8) as pipe:
            for first_idx, frames in pipe:
                ...
    """

    def __init__(self, scene, camera, positions, rotations, height, width,
                 batch=8, supersample=2, n_slots=3, n_threads=None):
        self._lib = load_library()
        tex, tpos, trot = _scene_arrays(scene)
        pos = np.ascontiguousarray(positions, dtype=np.float32)
        rot = np.ascontiguousarray(rotations, dtype=np.float32)
        self.batch = batch
        self.height = height
        self.width = width
        self.n_frames = (pos.shape[0] // batch) * batch
        nt = n_threads or max(1, (os.cpu_count() or 2) - 1)
        # Keep references so buffers outlive the C++ copies being made.
        self._keep = (tex, tpos, trot, pos, rot)
        self._handle = self._lib.asr_pipeline_create(
            *_scene_and_camera_args(scene, camera, tex, tpos, trot),
            _fp(pos), _fp(rot), self.n_frames, height, width, batch,
            int(supersample), int(n_slots), int(nt),
        )

    def __iter__(self):
        buf = np.empty((self.batch, self.height, self.width), dtype=np.float32)
        while True:
            first = self._lib.asr_pipeline_next(self._handle, _fp(buf))
            if first < 0:
                return
            yield first, buf.copy()

    def close(self):
        if self._handle:
            self._lib.asr_pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
