"""The port's apps: the simulation CLI (against the JAX CLI on the same
flags), the installation verifier and the ops tools, on the CPU."""

import contextlib
import csv
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from aprilslam_tpu.apps import run_simulation as JSIM
from aprilslam_tpu.apps import tools as JTOOLS
from aprilslam_tpu_torch.apps import run_simulation as TSIM
from aprilslam_tpu_torch.apps import tools as TTOOLS
from aprilslam_tpu_torch.apps import verify_install as TVERIFY

SMALL = ["--trajectory", "line", "--frames", "8", "--batch", "4", "--resolution", "256",
         "--estimator", "chain_avg", "--decimate", "1", "--headless"]
GT_COLS = ["GT_X", "GT_Y", "GT_Z", "GT_Roll", "GT_Pitch", "GT_Yaw"]
EST_COLS = ["Est_X", "Est_Y", "Est_Z"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(main, argv, cwd):
    """``main(argv)`` from ``cwd`` (the CLI writes data/logs there); returns
    (rc, the summary JSON of the last stdout line or None)."""
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        os.chdir(old)
    lines = out.getvalue().strip().splitlines()
    try:
        return rc, json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return rc, None


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    """The JAX CLI and the port's on the same flags, each from its own
    working directory."""
    base = tmp_path_factory.mktemp("clis")
    with jax.enable_x64(False):
        j = _run(JSIM.main, SMALL + ["--output-dir", "csv"], str(base / "jax"))
    t = _run(TSIM.main, SMALL + ["--output-dir", "csv", "--device", "cpu"], str(base / "torch"))
    return base, j, t


def test_flag_defaults():
    want, got = vars(JSIM.parse_arguments([])), vars(TSIM.parse_arguments([]))
    assert got.keys() == want.keys()
    assert got.pop("device") == "cuda" and want.pop("device") == "auto"
    assert got == want
    assert TSIM.parse_arguments(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        TSIM.parse_arguments(["--device", "tpu"])
    to_mm = lambda v: v * 5.56  # noqa: E731
    for v in (1.0, 10.0, 300.0):
        assert TSIM.fmt_distance(v, to_mm) == JSIM.fmt_distance(v, to_mm)


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(TSIM.main, SMALL + ["--output-dir", "csv"], str(tmp_path))
    assert not os.path.exists(tmp_path / "csv")  # raised before any work


def test_cli_matches_the_jax_cli(both_clis):
    base, (jrc, jsum), (trc, tsum) = both_clis
    assert jrc == trc == 0
    assert tsum["frames"] == jsum["frames"] >= 6
    assert tsum["estimator"] == jsum["estimator"] == "chain_avg"
    assert tsum["ate_rmse_su"] == pytest.approx(jsum["ate_rmse_su"], abs=0.02)
    assert tsum["ate_rmse_su"] < 1.8  # the reference's accuracy bar
    want = _rows(base / "jax" / "csv" / "slam_simulation_data.csv")
    got = _rows(base / "torch" / "csv" / "slam_simulation_data.csv")
    assert len(got) == len(want) == jsum["frames"]
    w = np.array([[float(r[c]) for c in GT_COLS] for r in want])
    g = np.array([[float(r[c]) for c in GT_COLS] for r in got])
    # Angles compared on the circle: roll = +-pi is one value.
    d = g - w
    d[:, 3:] = np.angle(np.exp(1j * d[:, 3:]))
    np.testing.assert_allclose(d, 0.0, atol=1e-4)
    w = np.array([[float(r[c]) for c in EST_COLS] for r in want])
    g = np.array([[float(r[c]) for c in EST_COLS] for r in got])
    np.testing.assert_allclose(g, w, atol=0.05)
    for name in ("error_analysis.csv", "covariance_analysis.csv"):
        assert len(_rows(base / "torch" / "csv" / name)) == len(_rows(base / "jax" / "csv" / name)) > 0
    assert os.path.exists(base / "torch" / "data" / "logs" / "simulation_runner.log")


def test_bad_config_error(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{\"display_width\": 100}")
    rc, _ = _run(TSIM.main, ["--config", str(bad), "--headless", "--device", "cpu"], str(tmp_path))
    assert rc == 2


def test_node_csvs_viz_and_analysis(tmp_path):
    """A run fills error_analysis.csv and covariance_analysis.csv, the offline
    analytics run on them, and --save-viz writes the three snapshots."""
    rc, summary = _run(TSIM.main, SMALL + ["--frames", "12", "--device", "cpu", "--output-dir", "csv",
                                           "--save-viz", "viz"], str(tmp_path))
    assert rc == 0 and summary["frames"] >= 9
    for name in ("error_analysis.csv", "covariance_analysis.csv"):
        assert len(_rows(tmp_path / "csv" / name)) > 0, name
    assert "Reproj_RMS" in _rows(tmp_path / "csv" / "slam_simulation_data.csv")[0]
    for png in ("map3d.png", "graph.png", "error_graph.png"):
        assert os.path.getsize(tmp_path / "viz" / png) > 0, png

    from aprilslam_tpu_torch.eval import covariance_report, error_analysis

    assert "Tag_Est_X" in covariance_report(str(tmp_path / "csv" / "covariance_analysis.csv"))
    res = error_analysis(str(tmp_path / "csv" / "slam_simulation_data.csv"))
    assert np.isfinite(res.mse) and len(res.labels) == summary["frames"]


def test_checkpoint_resume(tmp_path):
    from aprilslam_tpu_torch.utils import CheckpointManager

    common = SMALL + ["--device", "cpu", "--output-dir", "csv", "--checkpoint-dir", "ckpt",
                      "--checkpoint-every", "4"]
    rc, first = _run(TSIM.main, common, str(tmp_path))
    assert rc == 0
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 8
    rc, resumed = _run(TSIM.main, common + ["--resume"], str(tmp_path))
    assert rc == 0 and resumed["frames"] == first["frames"]
    with open(tmp_path / "data" / "logs" / "simulation_runner.log") as f:
        assert "Resumed SLAM state from checkpoint step 8" in f.read()


def test_interactive_run_on_a_piped_stdin(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("llwwaa" * 10))
    rc, _ = _run(TSIM.main, ["--frames", "4", "--batch", "2", "--resolution", "256",
                             "--estimator", "chain_avg", "--headless", "--interactive",
                             "--decimate", "1", "--device", "cpu", "--output-dir", "csv"],
                 str(tmp_path))
    assert rc in (0, 1)  # pose validity depends on where the keys drove
    assert os.path.exists(tmp_path / "csv" / "slam_simulation_data.csv")


def test_export_problem_is_not_ported_yet(tmp_path):
    """--export-problem is ported now (the name is kept from when it
    raised): under the chain estimator the run's problem carries the
    chaining graph's landmarks and loads in the refinement app."""
    from aprilslam_tpu_torch.apps.refine_trajectory import load_problem

    rc, summary = _run(TSIM.main, SMALL + ["--device", "cpu", "--export-problem", "run.npz"], str(tmp_path))
    assert rc == 0 and summary["exported_problem"] == "run.npz"
    prob, _K, tag = load_problem(str(tmp_path / "run.npz"), device="cpu")
    assert prob.n_keyframes == summary["exported_keyframes"] > 0 and tag > 0


def test_verify_install(capsys):
    assert TVERIFY.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "[ok]\033[0m functional render+detect smoke test" in out
    assert "[skip]\033[0m CCL kernel build" in out
    if not torch.cuda.is_available():
        assert TVERIFY.main([]) == 1
        assert "[FAIL]\033[0m CUDA device" in capsys.readouterr().out


def test_tools_randomize_matches_the_jax_tool(tmp_path, capsys):
    for seed in ("3", "11"):
        assert JTOOLS.main(["randomize", "--seed", seed, "-o", str(tmp_path / "j.json")]) == 0
        assert TTOOLS.main(["randomize", "--seed", seed, "-o", str(tmp_path / "t.json")]) == 0
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    log = tmp_path / "run.log"
    log.write_text("2026-01-01 00:00:00,000 INFO Scene: 5 tags\nfree text\n")
    capsys.readouterr()
    assert TTOOLS.main(["log", str(log)]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "[   INFO] 2026-01-01 00:00:00,000 | Scene: 5 tags", "          | free text"]
    assert TTOOLS.main(["log", str(tmp_path / "missing.log")]) == 2
