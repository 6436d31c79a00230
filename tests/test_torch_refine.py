"""The port's refinement app (``aprilslam-torch-refine``) and the simulation
CLI's ``--export-problem`` against the JAX package's, on the CPU."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from aprilslam_tpu.apps import refine_trajectory as JREF
from aprilslam_tpu.apps import run_simulation as JSIM
from aprilslam_tpu.parallel import synthesize_trajectory_problem as jax_synth
from aprilslam_tpu_torch.apps import refine_trajectory as TREF
from aprilslam_tpu_torch.apps import run_simulation as TSIM

DEMO = ["--demo", "--keyframes", "256", "--landmarks", "16", "--devices", "8"]
CLI = ["--trajectory", "line", "--frames", "8", "--batch", "4", "--resolution", "256",
       "--estimator", "ba", "--decimate", "1", "--headless"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(main, argv, cwd):
    """``main(argv)`` from ``cwd``; returns (rc, the JSON of the last stdout line)."""
    os.makedirs(cwd, exist_ok=True)
    old, out = os.getcwd(), io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_refine_demo_matches_jax(tmp_path):
    """The demo at 256 keyframes x 16 landmarks over 8 shards, at the app's
    24 x 128 iterations: the JAX app's keys; the drifted start's cost within
    1e-3 and the refined cost within 10 % of JAX's; the drift removed."""
    with jax.enable_x64(False):
        rc_j, want = _run(JREF.main, DEMO + ["--device", "cpu"], str(tmp_path / "jax"))
    rc, got = _run(TREF.main, DEMO + ["--device", "cpu", "--output", "refined.npz"], str(tmp_path / "torch"))
    assert rc == rc_j == 0
    assert set(got) == set(want) | {"output"}
    assert got["keyframes"] == 256 and got["landmarks"] == 16 and got["devices"] == want["devices"] == 8
    assert got["finite"] and got["ate_initial"] == pytest.approx(want["ate_initial"], abs=1e-3)
    assert got["cost_initial"] == pytest.approx(want["cost_initial"], rel=1e-3)
    assert got["cost_refined"] == pytest.approx(want["cost_refined"], rel=0.10)
    assert got["ate_refined"] <= 0.45 * got["ate_initial"], got
    prob, _K, tag = TREF.load_problem(str(tmp_path / "torch" / got["output"]), device="cpu")
    assert prob.n_keyframes == 256 and tag == 10.0


def test_refine_defaults_to_cuda():
    args = TREF.parse_arguments(["--demo"])
    assert args.device == "cuda" and args.devices == 0 and (args.iters, args.cg_iters) == (24, 128)
    with pytest.raises(SystemExit):
        TREF.parse_arguments(["--demo", "--device", "tpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TREF.main(["--demo", "--keyframes", "16", "--landmarks", "4"])


def test_problem_files_cross(tmp_path):
    """A problem saved by the JAX app loads in the port, and the reverse."""
    with jax.enable_x64(False):
        jp, _gt, jK = jax_synth(16, 4, 2, seed=1)
        JREF.save_problem(str(tmp_path / "jax.npz"), jp, jK, tag_size=7.5)
    prob, K, tag = TREF.load_problem(str(tmp_path / "jax.npz"), device="cpu")
    assert tag == 7.5
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
    for f in TREF.FIELDS:
        np.testing.assert_array_equal(getattr(prob, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    TREF.save_problem(str(tmp_path / "torch.npz"), prob, K, tag_size=tag)
    with jax.enable_x64(False):
        back, K2, tag2 = JREF.load_problem(str(tmp_path / "torch.npz"))
    assert tag2 == 7.5
    np.testing.assert_array_equal(np.asarray(K2), np.asarray(jK))
    for f in TREF.FIELDS:
        want = np.asarray(getattr(jp, f))
        got = np.asarray(getattr(back, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_problem_from_run_matches_jax():
    """problem_from_run on the same run outputs gives JAX's problem exactly:
    leading invalid frames trimmed, mixed-anchor frames inactive, odometry
    only between consecutive active frames."""
    rng = np.random.default_rng(4)
    B, D, M = 12, 3, 6
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(B, 3))
    valid = np.array([0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1], bool)
    coord = np.array([3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2], np.int32)
    ids = rng.integers(-1, M + 1, size=(B, D)).astype(np.int32)
    corners = rng.normal(size=(B, D, 4, 2)).astype(np.float32)
    ok = rng.random((B, D)) < 0.8
    lm_world = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    present = np.array([1, 1, 0, 1, 1, 1], bool)
    with jax.enable_x64(False):
        want = JREF.problem_from_run(poses, valid, coord, ids, corners, ok, lm_world, present, odom_weight=2.0)
    got = TREF.problem_from_run(poses, valid, coord, ids, corners, ok, lm_world, present, odom_weight=2.0,
                                device="cpu")
    for f in TREF.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both CLIs on the same 8-frame run with --export-problem."""
    base = tmp_path_factory.mktemp("export")
    with jax.enable_x64(False):
        j = _run(JSIM.main, CLI + ["--output-dir", "csv", "--export-problem", "run.npz"], str(base / "jax"))
    t = _run(TSIM.main, CLI + ["--output-dir", "csv", "--export-problem", "run.npz", "--device", "cpu"],
             str(base / "torch"))
    return base, j, t


def test_export_problem_matches_jax(exported):
    """The port's export has the JAX CLI's keyframe count, observations and
    active keyframes; its landmarks are the BA map in the anchor frame."""
    base, (rc_j, sj), (rc_t, st) = exported
    assert rc_j == rc_t == 0
    assert st["exported_problem"] == "run.npz" and st["exported_keyframes"] == sj["exported_keyframes"]
    prob, K, tag = TREF.load_problem(str(base / "torch" / "run.npz"), device="cpu")
    with jax.enable_x64(False):
        jprob, jK, jtag = JREF.load_problem(str(base / "jax" / "run.npz"))
    assert prob.n_keyframes == jprob.n_keyframes == sj["exported_keyframes"] > 0
    assert tag == jtag
    np.testing.assert_array_equal(K.numpy(), np.asarray(jK))
    for f in ("kf_active", "lm_active", "obs_kf", "obs_lm", "obs_ok", "odom_ok"):
        np.testing.assert_array_equal(getattr(prob, f).numpy(), np.asarray(getattr(jprob, f)), err_msg=f)
    assert int(prob.obs_ok.sum()) > 0
    act = prob.lm_active.numpy()
    # The anchor's own landmark is the identity in the anchor frame.
    assert np.allclose(prob.lm_pose.numpy()[act][:, 3], [0, 0, 0, 1])


def test_refine_reads_exported_problem(exported):
    base, _j, (_rc, st) = exported
    rc, rep = _run(TREF.main, ["--input", str(base / "torch" / st["exported_problem"]), "--iters", "6",
                               "--cg-iters", "24", "--device", "cpu"], str(base / "refine"))
    assert rc == 0 and rep["finite"] and rep["keyframes"] == st["exported_keyframes"]
    assert rep["cost_refined"] <= rep["cost_initial"]
