"""The port's native runtime (its own copies of the JAX package's C++
sources): the CPU rasterizer and the frame pipeline against both packages'
``render_frames``, and the Y4M reader against the file's own bytes.

The JAX package's ``runtime.load_library`` is not called here: it builds
its library in place in its package directory, which another test process
may be doing at the same time. The sources are byte-identical
(``tests/test_torch_imports.py``), so the port's native output is the JAX
package's by construction."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu import sim as JSIM
from aprilslam_tpu_torch import runtime
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.runtime import FramePipeline, Y4MReader, render_frames_native
from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory

POS = np.asarray([[0.0, 0.0, 10.0], [6.0, 2.0, -4.0]], np.float32)
ROT = np.asarray([[0.0, 0.0, 0.0], [3.0, -5.0, 2.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(256, 256, cfg.fov_y)
    return cfg, cam, scene_tensors(cfg, device="cpu")


def _within_raster_bounds(ours, ref):
    """The JAX package's bounds for its native rasterizer
    (tests/test_runtime.py): cell-edge pixels may differ by round-off."""
    diff = np.abs(ours - ref)
    assert (diff > 0.5).mean() < 0.002, (diff > 0.5).mean()
    assert diff.mean() < 0.01, diff.mean()


def test_builds_into_build_dir_and_versions():
    path, _ = runtime.build_runtime()
    assert path.parent == runtime.BUILD_DIR and path.name.startswith("runtime_")
    assert runtime.build_runtime() == (path, 0.0)  # cached: no second compile
    assert runtime.load_library().asr_version() == 1


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(runtime, "SOURCES", [bad])
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.build_runtime()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("ss", [1, 2])
def test_native_matches_both_rasterizers(setup, ss):
    cfg, cam, scene = setup
    ours = render_frames_native(scene, POS, ROT, cam, 256, 256, supersample=ss)
    port = render_frames(scene, POS, ROT, cam.inv_matrix, 256, 256, ss, device="cpu").numpy()
    ref = np.asarray(JSIM.render_frames(JSIM.scene_tensors(cfg), jnp.asarray(POS), jnp.asarray(ROT),
                                        jnp.asarray(cam.inv_matrix), 256, 256, ss))
    assert ours.shape == (2, 256, 256) and ours.dtype == np.float32
    _within_raster_bounds(ours, port)
    _within_raster_bounds(ours, ref)
    assert ours.std() > 0.05  # scene content present


def test_pipeline_streams_every_batch_as_the_sync_render(setup):
    cfg, cam, scene = setup
    traj = trajectory.scripted_line(12, np.array([0, 0, 20.0]), np.array([4, 1, 5.0]))
    got = {}
    with FramePipeline(scene, cam, traj.positions, traj.rotations, height=96, width=96,
                       batch=4, supersample=1, n_threads=2) as pipe:
        for first, frames in pipe:
            assert frames.shape == (4, 96, 96)
            got[first] = frames
    assert sorted(got) == [0, 4, 8]
    sync = render_frames_native(scene, traj.positions, traj.rotations, cam, 96, 96, 1)
    port = render_frames(scene, traj.positions, traj.rotations, cam.inv_matrix, 96, 96, 1,
                         device="cpu").numpy()
    for first, frames in got.items():
        np.testing.assert_allclose(frames, sync[first:first + 4], atol=1e-6)
        _within_raster_bounds(frames, port[first:first + 4])


def _write_y4m(path, frames, cspace):
    """A Y4M file with grey chroma planes; returns the file's bytes."""
    H, W = frames.shape[1:]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F25:1 Ip A1:1 C{cspace}\n".encode())
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            if cspace == "420":
                f.write(b"\x80" * (H * W // 2))
            elif cspace == "444":
                f.write(b"\x80" * (H * W * 2))
    return path.read_bytes()


@pytest.mark.parametrize("cspace,chroma", [("420", 0.5), ("444", 2.0), ("mono", 0.0)])
def test_y4m_reads_the_luma_planes(tmp_path, rng, cspace, chroma):
    frames = rng.integers(0, 256, (5, 32, 48), dtype=np.uint8)
    raw = _write_y4m(tmp_path / f"t_{cspace}.y4m", frames, cspace)
    with Y4MReader(str(tmp_path / f"t_{cspace}.y4m")) as r:
        assert (r.width, r.height) == (48, 32)
        assert abs(r.fps - 25.0) < 1e-9
        got = r.read_batch(8)  # more than there are: stops at EOF
    # Oracle: the luma bytes cut from the file itself.
    header = raw.index(b"\n") + 1
    plane, frame_bytes = 32 * 48, len(b"FRAME\n") + int(32 * 48 * (1 + chroma))
    luma = [raw[header + k * frame_bytes + 6: header + k * frame_bytes + 6 + plane] for k in range(5)]
    assert header + 5 * frame_bytes == len(raw)
    assert got.shape == (5, 32, 48) and got.dtype == np.uint8
    assert [g.tobytes() for g in got] == luma


def test_y4m_eof_and_bad_file(tmp_path):
    _write_y4m(tmp_path / "t.y4m", np.zeros((2, 16, 16), np.uint8), "420")
    with Y4MReader(str(tmp_path / "t.y4m")) as r:
        assert r.read_batch(2).shape == (2, 16, 16)
        assert r.read() is None
        assert r.read_batch(4).shape == (0, 16, 16)
    (tmp_path / "bad.y4m").write_bytes(b"NOT A STREAM")
    with pytest.raises(OSError):
        Y4MReader(str(tmp_path / "bad.y4m"))
    with pytest.raises(OSError):
        Y4MReader(str(tmp_path / "missing.y4m"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        runtime.build_runtime()
    assert not list((tmp_path / "build").iterdir())
