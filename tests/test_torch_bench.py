"""The port's bench (``bench_torch.py``) and its CLI (``aprilslam-torch-bench``)
against ``bench.py`` and the JAX CLI, on the CPU."""

import contextlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.apps import bench_cli as JCLI
from aprilslam_tpu.geometry import PinholeCamera as JCamera
from aprilslam_tpu.sim import SceneConfig as JSceneConfig
from aprilslam_tpu.sim import render_frames as j_render_frames
from aprilslam_tpu.sim import scene_tensors as j_scene_tensors
from aprilslam_tpu.sim import trajectory as j_trajectory
from aprilslam_tpu_torch.apps import bench_cli as TCLI
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu_torch.slam import build_slam_step

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ["BENCH_DEVICE", "BENCH_BATCH", "BENCH_RES", "BENCH_FRAMES", "BENCH_PASSES", "BENCH_BUDGET_S",
         "BENCH_ATE_MAX", "BENCH_GRAPH_CAP", "BENCH_CHUNK_ITERS", "BENCH_PNP_ITERS", "BENCH_SWEEP",
         "BENCH_SWEEP_BATCHES", "BENCH_STAGES", "BENCH_PGO", "BENCH_MULTISEQ", "BENCH_VIDEO",
         "BENCH_ESTIMATOR", "BENCH_BA_SCHEDULE", "BENCH_KF", "BENCH_OBS", "BENCH_FRAME_CACHE",
         "BENCH_OBS_MIN", "BENCH_CHUNKS", "BENCH_FALLBACK"]
# The parity run: bench.py's CPU mode on a pool of its own poses.
PARITY_RES, PARITY_FRAMES = 384, 16
# The port's ATE against bench.py's on that pool, relative. Measured gap on
# the CPU: 0.12 % (bench.py 1.2845 su, the port 1.2860, each over the same
# 15 valid frames of 16).
ATE_REL_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def knobs(monkeypatch, tmp_path, bench):
    """No bench knob from the caller's environment; caches and the partial
    line under ``tmp_path``; ``set(**knobs)`` sets knobs for one test."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(bench, "CACHE_PREFIX", str(tmp_path / "cache_"))
    monkeypatch.setattr(bench, "PARTIAL_PATH", tmp_path / "BENCH_partial_torch.json")
    monkeypatch.setattr(sys, "path", list(sys.path))
    return lambda **kv: [monkeypatch.setenv(k, str(v)) for k, v in kv.items()]


@contextlib.contextmanager
def process_restored():
    """Leave the process as it was found, whatever ran inside: the
    ``bench_torch`` entry of ``sys.modules`` (the CLI registers the bench it
    loads under that name), every ``BENCH_*`` variable (the CLI writes
    ``os.environ`` itself) and ``sys.path``. Unlike ``monkeypatch.delenv``
    on an absent key, this undoes a key that was absent before."""
    absent = object()
    module = sys.modules.get("bench_torch", absent)
    env = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    path = list(sys.path)
    try:
        yield
    finally:
        if module is absent:
            sys.modules.pop("bench_torch", None)
        else:
            sys.modules["bench_torch"] = module
        for k in [k for k in os.environ if k.startswith("BENCH_") and k not in env]:
            del os.environ[k]
        os.environ.update(env)
        sys.path[:] = path


def run_cli(cli, argv) -> int:
    """``cli.main(argv)`` inside ``process_restored``: every CLI test calls
    a CLI through this."""
    with process_restored():
        return cli.main(argv)


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _small_cpu_run(knobs, tmp_path, **extra):
    knobs(BENCH_DEVICE="cpu", BENCH_RES=256, BENCH_FRAMES=4, BENCH_PASSES=1,
          BENCH_FRAME_CACHE=tmp_path / "pool.npy", **extra)


@pytest.fixture(scope="module")
def jax_pool(tmp_path_factory):
    """bench.py's headline pool on the CPU: JAX ``monte_carlo(n, seed=3)``
    poses rendered by the JAX rasterizer, cast to uint8 as bench.py does."""
    with jax.enable_x64(False):
        cfg = JSceneConfig.from_file()
        cam = JCamera.from_fov(PARITY_RES, PARITY_RES, cfg.fov_y)
        scene = j_scene_tensors(cfg)
        traj = j_trajectory.monte_carlo(PARITY_FRAMES, seed=3)
        pos, rot = jnp.asarray(traj.positions), jnp.asarray(traj.rotations)
        parts = [jnp.clip(j_render_frames(scene, pos[i:i + 8], rot[i:i + 8], jnp.asarray(cam.inv_matrix),
                                          PARITY_RES, PARITY_RES, 2) * 255.0, 0, 255).astype(jnp.uint8)
                 for i in range(0, PARITY_FRAMES, 8)]
        pool = np.concatenate([np.asarray(p) for p in parts])
    path = tmp_path_factory.mktemp("pool") / "pool.npy"
    np.save(path, pool)
    return path, trajectory.Trajectory(np.asarray(traj.positions, np.float32),
                                       np.asarray(traj.rotations, np.float32))


def test_headline_parity_with_bench_py(bench, knobs, jax_pool, tmp_path, monkeypatch, capsys):
    """bench.py (a CPU subprocess) and the port's headline on one pool and
    one set of poses: the same valid frames, ATE within ATE_REL_TOL, and the
    same keys bar ``device_fallback`` (bench.py's) and ``card``/``pool``."""
    path, traj = jax_pool
    run_knobs = dict(BENCH_DEVICE="cpu", BENCH_FRAME_CACHE=str(path), BENCH_RES=str(PARITY_RES),
                     BENCH_FRAMES=str(PARITY_FRAMES), BENCH_PASSES="1")
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(run_knobs, JAX_PLATFORMS="cpu", APRILSLAM_CACHE_DIR=str(tmp_path / "jax_cache"),
               PYTHONPATH=os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    # A copy of bench.py, so that its mirror file (BENCH_partial.json, written
    # beside the script) lands under tmp_path and not in the checkout.
    jax_dir = tmp_path / "jax_bench"
    jax_dir.mkdir()
    shutil.copy(ROOT / "bench.py", jax_dir / "bench.py")
    res = subprocess.run([sys.executable, "bench.py"], cwd=jax_dir, env=env, capture_output=True, text=True,
                         timeout=400)
    assert res.returncode == 0, res.stderr[-4000:]
    jax_lines = _json_lines(res.stdout)
    assert json.loads((jax_dir / "BENCH_partial.json").read_text()) == jax_lines[-1]

    knobs(**run_knobs)
    monkeypatch.setattr(bench, "headline_poses", lambda n: (traj, "jax_monte_carlo"))
    assert bench.main() == 0
    port_lines = _json_lines(capsys.readouterr().out)

    assert len(jax_lines) == len(port_lines) == 2
    for j, t in zip(jax_lines, port_lines):
        assert set(t) == (set(j) - {"device_fallback"}) | {"card", "pool"}
    j, t = jax_lines[0], port_lines[0]
    assert t["valid_pose_rate"] == j["valid_pose_rate"]
    assert t["invalid_frames"] == j["invalid_frames"]
    assert t["ate_rmse_sim_units"] == pytest.approx(j["ate_rmse_sim_units"], rel=ATE_REL_TOL)
    assert t["frames_timed"] == j["frames_timed"] and t["batch"] == j["batch"] == 4
    assert t["device"] == "cpu" and t["card"] is None and t["pool"] == "jax_monte_carlo"
    assert port_lines[1] == {**t, "total_s": port_lines[1]["total_s"]}


def test_cli_without_a_gpu_exits_nonzero(knobs, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    monkeypatch.chdir(ROOT)
    assert run_cli(TCLI, []) != 0
    out = capsys.readouterr()
    assert _json_lines(out.out) == []
    assert "CUDA" in out.err


def test_failed_leg_is_named_and_fails_the_run(bench, knobs, tmp_path, monkeypatch, capsys):
    # No ATE ceiling: this run is about the leg (4 frames at 256x256 are far
    # from the headline's accuracy).
    _small_cpu_run(knobs, tmp_path, BENCH_VIDEO=1, BENCH_ATE_MAX=1e9)

    def broken(*args, **kwargs):
        raise RuntimeError("the leg broke")

    monkeypatch.setattr(bench, "bench_video_leg", broken)
    assert bench.main() == 1
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 2 and "extras_failed" not in lines[0]
    assert lines[-1]["extras_failed"] == ["video"] and "video" not in lines[-1]
    assert json.loads((tmp_path / "BENCH_partial_torch.json").read_text()) == lines[-1]


def test_ate_gate_exits_3_after_both_lines(bench, knobs, tmp_path, capsys):
    _small_cpu_run(knobs, tmp_path, BENCH_ATE_MAX=0)
    assert bench.main() == 3
    first, last = _json_lines(capsys.readouterr().out)
    assert first["ate_gate"] == last["ate_gate"] == {"max": 0.0, "pass": False}
    assert set(first) < set(last) and "total_s" in last
    assert first["pool"] == "monte_carlo_numpy" and first["batch_choice"] == "sweep_winner"


FAKE_BENCH = (
    "import json, os\n"
    "def main():\n"
    "    with open('knobs.json', 'w') as f:\n"
    "        json.dump({k: v for k, v in os.environ.items() if k.startswith('BENCH_')}, f)\n"
    "    return 7\n"
)


@pytest.mark.parametrize("argv", [
    [],
    ["--batch", "16", "--resolution", "512", "--chunks", "3"],
    ["--cpu"],
    ["--device", "cpu", "--batch", "4"],
])
def test_cli_maps_flags_as_the_jax_cli(argv, knobs, tmp_path, monkeypatch):
    """Both CLIs set the same knobs from the same flags (the port's CLI
    also returns the bench's exit code; the JAX CLI always returns 0)."""
    got = {}
    for name, cli, script in (("jax", JCLI, "bench.py"), ("torch", TCLI, "bench_torch.py")):
        d = tmp_path / name
        d.mkdir()
        (d / script).write_text(FAKE_BENCH)
        monkeypatch.chdir(d)
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        rc = run_cli(cli, argv)
        got[name] = rc, json.loads((d / "knobs.json").read_text())
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][0] == 7 and got["jax"][0] == 0


def test_cli_without_bench_file_returns_2(knobs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert run_cli(TCLI, []) == 2
    assert "bench_torch.py not found in cwd" in capsys.readouterr().err


@pytest.mark.parametrize("bench_before", ["absent", "another"])
def test_cli_leaves_the_process_as_it_found_it(bench_before, tmp_path, monkeypatch):
    """The CLI registers the bench it runs as ``sys.modules["bench_torch"]``
    and sets BENCH_* variables; after ``run_cli`` the module entry, every
    BENCH_* variable and ``sys.path`` are as before, whether the entry was
    absent or held another module. (A fake bench left there by this test's
    CLI call once broke ``tests/test_torch_probes.py`` in the same worker.)"""
    (tmp_path / "bench_torch.py").write_text(FAKE_BENCH)
    monkeypatch.chdir(tmp_path)
    if bench_before == "absent":
        monkeypatch.delitem(sys.modules, "bench_torch", raising=False)
    else:
        monkeypatch.setitem(sys.modules, "bench_torch", types.ModuleType("bench_torch"))
    monkeypatch.setenv("BENCH_RES", "123")
    for k in ("BENCH_BATCH", "BENCH_CHUNKS", "BENCH_DEVICE"):
        monkeypatch.delenv(k, raising=False)
    before_module = sys.modules.get("bench_torch")
    before_env = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    before_path = list(sys.path)
    assert run_cli(TCLI, ["--cpu", "--batch", "4"]) == 7
    # The CLI did run, and set its knobs while it ran.
    assert json.loads((tmp_path / "knobs.json").read_text())["BENCH_DEVICE"] == "cpu"
    assert sys.modules.get("bench_torch") is before_module
    assert {k: v for k, v in os.environ.items() if k.startswith("BENCH_")} == before_env
    assert sys.path == before_path


def _frames(cfg, cam, traj, res):
    scene = scene_tensors(cfg, device="cpu")
    return torch.clamp(render_frames(scene, traj.positions, traj.rotations, cam.inv_matrix, res, res, 2,
                                     device="cpu") * 255.0, 0, 255).to(torch.uint8)


def test_stage_breakdown_gives_bench_py_keys(bench):
    names = re.findall(r'ms\["(\w+)"\]', (ROOT / "bench.py").read_text())
    assert len(names) == 4
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(256, 256, cfg.fov_y)
    frames = _frames(cfg, cam, trajectory.monte_carlo(2, seed=3), 256)
    cpu = torch.device("cpu")
    ms, skipped = bench.stage_breakdown(cfg, frames, bench.headline_params(), 1e3, cpu, bench.Run(500.0), reps=2)
    assert list(ms) == names and skipped == []
    assert all(v >= 0.0 for v in ms.values()), ms
    # Out of budget, no stage runs and the first is named.
    ms, skipped = bench.stage_breakdown(cfg, frames, bench.headline_params(), 1e3, cpu, bench.Run(0.0))
    assert ms == {} and skipped == ["thr_ccl"]


def test_multiseq_leg_equals_each_sequence_alone(bench, knobs, tmp_path):
    """Config 3 at 2 sequences x batch 2: each sequence's outputs are those
    of its own step run on its own frames in the same order."""
    res, n_seq, batch, passes = 256, 2, 2, 1
    cfg = SceneConfig.from_file()
    params = bench.headline_params()
    report, outs = bench.bench_multiseq_leg(cfg, params, res, torch.device("cpu"), bench.Run(500.0),
                                            n_seq=n_seq, batch=batch, passes=passes)
    assert report["frames_timed"] == passes * 2 * n_seq * batch
    assert len(outs) == 1 + passes * 2
    last = outs[-1]
    assert report["valid_rate"] == round(float(last.valid.float().mean()), 4)
    arr = np.load(f"{bench.CACHE_PREFIX}multiseq_{res}_S{n_seq}_B{batch}.npy")
    assert arr.shape == (2, n_seq, batch, res, res)
    cam = PinholeCamera.from_fov(res, res, cfg.fov_y)
    for s in range(n_seq):
        t = trajectory.monte_carlo(batch, seed=100 + 10 * s + 1)
        assert np.array_equal(arr[1, s], _frames(cfg, cam, t, res).numpy())
        step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=params,
                                     estimator="ba", ba_schedule="chunk", init_joint_iters=3,
                                     ba_chunk_iters=4, pnp_iters=3, graph_capacity=16, device="cpu")
        st, o = step(init(), torch.as_tensor(arr[0, s]))
        for _ in range(passes):
            for k in range(2):
                st, o = step(st, torch.as_tensor(arr[k, s]))
        assert torch.equal(last.valid[s], o.valid)
        assert torch.equal(last.poses[s], o.poses)
