"""The port's SLAM service on the CPU: the same poses as the in-process step
(the port's and the JAX package's), error responses for malformed requests,
concurrent clients, and the JAX package's client talking to it."""

import json
import socket
import struct
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.apps import serve as JSERVE
from aprilslam_tpu.detect import DetectorParams as JParams
from aprilslam_tpu.geometry import PinholeCamera as JCam
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu.slam import SlamSystem as JSlam
from aprilslam_tpu_torch.apps import serve as TSERVE
from aprilslam_tpu_torch.apps.serve import SlamClient, _recv_msg, _send_msg, make_server
from aprilslam_tpu_torch.detect import DetectorParams
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.slam import SlamSystem

RES, BATCH, N_CHUNKS = 256, 4, 3


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frames():
    cfg = SceneConfig.from_file()
    cam = JCam.from_fov(RES, RES, cfg.fov_y)
    traj = trajectory.scripted_line(BATCH * N_CHUNKS, np.array([0.0, 0.0, 20.0]),
                                    np.array([6.0, 2.0, -5.0]))
    with jax.enable_x64(False):
        f = np.asarray(render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                                     jnp.asarray(traj.rotations), jnp.asarray(cam.inv_matrix),
                                     RES, RES, 2))
    u8 = np.clip(f * 255.0, 0, 255).astype(np.uint8)
    return [u8[c * BATCH:(c + 1) * BATCH] for c in range(N_CHUNKS)]


@pytest.fixture(scope="module")
def service(one_thread):
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    dp = DetectorParams(quad_decimate=1, min_cluster_pts=12)
    port = _free_port()
    srv = make_server("127.0.0.1", port, cam, cfg.family, cfg.tag_size_inner,
                      BATCH, RES, 1, estimator="ba", detector_params=dp, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield cfg, cam, dp, port
    srv.shutdown()
    srv.server_close()
    th.join(timeout=30)


def _poses(rep):
    assert rep["ok"], rep
    return np.asarray(rep["poses"]), np.asarray(rep["valid"])


def test_ping_process_stats_reset(service, frames):
    cfg, cam, dp, port = service
    cli = SlamClient(port=port)
    ping = cli.ping()
    assert ping == {"ok": True, "shape": [BATCH, RES, RES]}
    assert cli.reset()["ok"]
    base = cli.stats()
    assert base["ok"] and base["compile_s"] >= 0.0
    reps = [cli.process(c) for c in frames]
    for rep in reps:
        assert set(rep) == {"ok", "poses", "valid", "coord_id", "n_nodes", "pose_obs", "latency_ms"}
        poses, valid = _poses(rep)
        assert poses.shape == (BATCH, 4, 4) and np.isfinite(poses).all()
        assert valid.sum() >= BATCH - 1

    # The port's in-process step on the same frames, to 1e-3.
    ref = SlamSystem(cam, cfg.family, cfg.tag_size_inner, estimator="ba", detector_params=dp,
                     ba_schedule="chunk", device="cpu")
    for rep, c in zip(reps, frames):
        out = ref.process(c)
        poses, valid = _poses(rep)
        np.testing.assert_array_equal(valid, out.valid.numpy())
        np.testing.assert_array_equal(rep["coord_id"], out.coord_id.numpy())
        np.testing.assert_array_equal(rep["n_nodes"], out.n_nodes.numpy())
        np.testing.assert_allclose(poses[valid], out.poses.numpy()[valid], atol=1e-3)

    # The JAX package's in-process step, with the pose tolerance of the step
    # parity tests (tests/test_torch_slam.py).
    jcam = JCam.from_fov(RES, RES, cfg.fov_y)
    with jax.enable_x64(False):
        jslam = JSlam(jcam, cfg.family, cfg.tag_size_inner, estimator="ba",
                      detector_params=JParams(quad_decimate=1, min_cluster_pts=12), ba_schedule="chunk")
        jouts = [jax.device_get(jslam.process(c)) for c in frames]
    for rep, jo in zip(reps, jouts):
        poses, valid = _poses(rep)
        np.testing.assert_array_equal(valid, np.asarray(jo.valid))
        np.testing.assert_array_equal(rep["coord_id"], np.asarray(jo.coord_id))
        np.testing.assert_allclose(poses[valid], np.asarray(jo.poses)[valid], atol=2e-3, rtol=1e-4)

    st = cli.stats()
    assert st["requests"] == base["requests"] + N_CHUNKS
    assert st["frames"] == base["frames"] + N_CHUNKS * BATCH
    assert st["fps_busy"] > 0

    # After a reset the map rebuilds from scratch: the same poses again.
    assert cli.reset()["ok"]
    again, valid = _poses(cli.process(frames[0]))
    first, _ = _poses(reps[0])
    np.testing.assert_allclose(again[valid], first[valid], atol=1e-3)
    cli.close()


def test_malformed_requests_get_error_responses(service):
    cfg, cam, dp, port = service
    cli = SlamClient(port=port, timeout=20.0)
    n = BATCH * RES * RES
    r = cli._call({"cmd": "process", "shape": [BATCH, RES, RES]}, b"\0" * 10)
    assert not r["ok"] and "payload" in r["error"], r
    r = cli._call({"cmd": "process", "shape": [BATCH, RES, RES]}, b"\0" * (n + 7))
    assert not r["ok"] and "payload" in r["error"], r
    r = cli._call({"cmd": "process", "shape": "big"}, b"")
    assert not r["ok"] and "shape" in r["error"], r
    r = cli._call({"cmd": "process", "shape": [1, 2, 3]}, b"\0" * 6)
    assert not r["ok"] and "server shape" in r["error"], r
    r = cli._call({"cmd": "fly"})
    assert not r["ok"] and "unknown cmd" in r["error"], r
    _send_msg(cli.sock, b"[1, 2]")
    _send_msg(cli.sock, b"")
    r = json.loads(_recv_msg(cli.sock))
    assert not r["ok"] and "JSON object" in r["error"], r
    _send_msg(cli.sock, b"this is not json")
    _send_msg(cli.sock, b"")
    r = json.loads(_recv_msg(cli.sock))
    assert not r["ok"], r
    assert cli.ping()["ok"]  # the connection survives every error above
    # An oversize header length prefix: an error response, then the close.
    cli.sock.sendall(struct.pack(">Q", 1 << 40))
    r = json.loads(_recv_msg(cli.sock))
    assert not r["ok"] and "large" in r["error"], r
    cli.close()


def test_concurrent_clients_and_reset_under_load(service, frames):
    """Clients send process() while another thread resets: every response is
    well formed, poses stay finite, and the request count adds up (the lock
    serializes map access)."""
    cfg, cam, dp, port = service
    n_clients, n_reqs = 3, 2
    errors: list = []
    done = threading.Event()

    def worker(k):
        try:
            c = SlamClient(port=port, timeout=300.0)
            for i in range(n_reqs):
                poses, _ = _poses(c.process(frames[(k + i) % N_CHUNKS]))
                assert np.isfinite(poses).all()
            c.close()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    def resetter():
        c = SlamClient(port=port, timeout=300.0)
        while not done.is_set():
            if not c.reset()["ok"]:
                errors.append("reset failed")
            done.wait(0.05)
        c.close()

    base = SlamClient(port=port).stats()["requests"]
    rt = threading.Thread(target=resetter)
    rt.start()
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    done.set()
    rt.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not rt.is_alive()
    assert not errors, errors
    assert SlamClient(port=port).stats()["requests"] == base + n_clients * n_reqs


def test_the_jax_client_talks_to_the_port_server(service, frames):
    cfg, cam, dp, port = service
    cli = JSERVE.SlamClient(port=port)
    assert cli.ping() == {"ok": True, "shape": [BATCH, RES, RES]}
    assert cli.reset()["ok"]
    poses, valid = _poses(cli.process(frames[0]))
    assert poses.shape == (BATCH, 4, 4) and valid.any()
    assert cli.stats()["ok"]
    cli.close()


def test_the_service_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSERVE.main(["--port", str(_free_port()), "--resolution", "64", "--batch", "1"])
    cam = PinholeCamera.from_fov(64, 64, 45.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server("127.0.0.1", _free_port(), cam, "tagStandard41h12", 10.0, 1, 64, 1)
