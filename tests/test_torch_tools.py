"""The port's measurement tools (``tools/scaling_bench_torch.py`` with its
process worker, ``tools/profile_step_torch.py``) against the JAX package's
``tools/scaling_bench.py``, on the CPU.

JAX runs through its own tool as a subprocess (two virtual CPU devices),
started once for the module so it overlaps the port's work. A small driver
imports the tool, saves the world (lm) or the problem (kf) it builds, and
runs its ``main()``; it jits ``keyframe_ba_cost``, which the tool calls
eagerly three times (one compile in place of one per op: half the run's
time on the CPU). The port's side runs the tools' functions at
``--device cpu``.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aprilslam_tpu_torch.convert import keyframe_problem_from_jax_numpy

ROOT = Path(__file__).resolve().parents[1]
LM = ["--mode", "lm", "--landmarks", "256", "--keyframes", "16", "--obs", "1024", "--devices", "2",
      "--iters", "2", "--reps", "1"]
KF = ["--mode", "kf", "--keyframes", "512", "--landmarks", "64", "--devices", "2", "--iters", "2",
      "--cg-iters", "8", "--reps", "1"]
KF_PROC = ["--mode", "kf-proc", "--platform", "cpu", "--processes", "2", "--keyframes", "256", "--landmarks", "64",
           "--iters", "2", "--cg-iters", "8", "--reps", "1"]
WALL_S = 120  # each JAX run's and each kf-proc count's wall clock
JAX_DRIVER = r"""
import dataclasses, os, sys
import numpy as np
root, out = sys.argv[1], sys.argv[2]
sys.path[:0] = [os.path.join(root, "tools"), root]
import jax
jax.config.update("jax_platforms", "cpu")
import aprilslam_tpu.parallel as par
import aprilslam_tpu.slam.ba as ba
import scaling_bench

def fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}

cost = ba.ba_cost
def ba_cost(st, K, tag):  # the lm mode's first call holds its world
    if not os.path.exists(out):
        np.savez(out, K=np.asarray(K), **fields(st))
    return cost(st, K, tag)
ba.ba_cost = ba_cost
synth = par.synthesize_trajectory_problem
def synthesize(*a, **k):
    prob, gt, K = synth(*a, **k)
    np.savez(out, kf_gt=gt, K=np.asarray(K), **fields(prob))
    return prob, gt, K
par.synthesize_trajectory_problem = synthesize
par.keyframe_ba_cost = jax.jit(par.keyframe_ba_cost, static_argnums=2)
sys.argv = ["scaling_bench.py"] + sys.argv[3:]
scaling_bench.main()
"""
# The JAX tool's keys per mode (tools/scaling_bench.py:188-207, :359-384,
# tools/scaling_proc_worker.py:155-166 and the kf-proc summary :265-279).
LM_KEYS = {"landmarks", "keyframes", "observations", "max_obs_per_landmark", "lm_iters", "cost_initial",
           "cost_single", "cost_distributed", "t_single_s", "t_distributed_s", "devices", "speedup",
           "scaling_efficiency_measured", "flops_single", "flops_distributed_per_device",
           "work_scaling_efficiency", "ba_iters_per_sec_distributed", "note"}
KF_KEYS = {"mode", "keyframes", "landmarks", "observations", "lm_iters", "cg_iters", "cost_initial",
           "cost_single", "cost_distributed", "ate_initial", "ate_distributed", "trajectory_span_su",
           "t_single_s", "t_distributed_s", "devices", "speedup", "scaling_efficiency_measured",
           "work_scaling_efficiency", "work_scaling_efficiency_raw", "note"}
PROC_KEYS = {"processes", "keyframes", "landmarks", "observations", "lm_iters", "cg_iters", "t_solve_s",
             "t_per_lm_iter_s", "t_collectives_per_lm_iter_s", "cost_final", "ate_initial", "ate_final",
             "trajectory_span_su", "oversubscribed"}
SUMMARY_KEYS = {"summary", "host_cpus", "per_lm_iter_s", "collectives_per_lm_iter_s", "speedup_vs_1proc", "note"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sb():
    return _load("scaling_bench_torch")


class JaxRuns:
    """The JAX tool's lm and kf runs, started together in the background."""

    def __init__(self, tmp: Path):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=2")
        self.procs = {
            mode: (tmp / f"{mode}.npz", subprocess.Popen(
                [sys.executable, "-c", JAX_DRIVER, str(ROOT), str(tmp / f"{mode}.npz"), *argv],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp))
            for mode, argv in (("lm", LM), ("kf", KF))}

    def result(self, mode: str):
        """(the tool's JSON line, the arrays it built)."""
        path, proc = self.procs[mode]
        out, err = proc.communicate(timeout=WALL_S)
        assert proc.returncode == 0, err[-3000:]
        line = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
        with np.load(path) as z:
            return line, dict(z)

    def close(self):
        for _path, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_tools"))
    yield runs
    runs.close()


def test_kf_proc_two_gloo_ranks_match_stacked(sb, capsys):
    """Two gloo processes of the worker give the 2-shard stacked solve's
    cost and ATE. Measured gaps on the CPU: cost 0.0 (tolerance 1e-5
    relative), ATE 1.7e-8 relative (1e-5)."""
    from aprilslam_tpu_torch.parallel import build_keyframe_ba, make_mesh, synthesize_trajectory_problem

    args = sb.parse_args(KF_PROC)
    res = sb.kf_proc_bench(args, wall_s=WALL_S)
    assert not res["failed"], capsys.readouterr().out[-3000:]
    (row,) = res["rows"]
    assert PROC_KEYS <= set(row) and row["backend"] == "gloo" and row["processes"] == 2
    assert SUMMARY_KEYS <= set(res["summary"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == [row, res["summary"]]

    prob, kf_gt, K = synthesize_trajectory_problem(args.keyframes, args.landmarks, 2, obs_per_kf=4, seed=7,
                                                   device="cpu")
    run = build_keyframe_ba(make_mesh(2, axis="kf", device="cpu"), prob.n_keyframes, prob.n_landmarks,
                            int(prob.obs_kf.shape[0]), 10.0, iters=args.iters, cg_iters=args.cg_iters)
    out, cost = run(prob, K)
    assert abs(row["cost_final"] - cost) <= 1e-5 * cost, (row["cost_final"], cost)
    e = out.kf_pose[:, :3, 3].numpy() - kf_gt[:, :3, 3]
    assert row["ate_final"] == pytest.approx(float(np.sqrt(np.mean(np.sum(e * e, -1)))), rel=1e-5)
    assert row["ate_final"] < row["ate_initial"]


def test_profile_tool_buckets_sum_to_total(monkeypatch, capsys):
    """2 frames at 256x256 on the CPU: every detector stage and the back
    end's buckets get time, and the buckets sum to the reported total."""
    tool = _load("profile_step_torch")
    monkeypatch.setenv("B", "2")
    monkeypatch.setenv("RES", "256")
    assert tool.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== cpu time per stage (us, 3 calls x 2 frames) ==" in out and "== top ops in the 2 biggest stages ==" in out
    prof = json.loads(out.strip().splitlines()[-1])["profile"]
    stages = prof["stages_us_per_frame"]
    for b in (*tool.STAGES, *tool.BACKEND.values()):
        assert stages.get(b, 0.0) > 0.0, (b, stages)
    assert sum(stages.values()) == pytest.approx(prof["total_us_per_frame"], rel=1e-9)
    assert set(prof["jax_buckets"]) == set(tool.JAX_BUCKETS)
    assert sum(prof["jax_buckets"].values()) == pytest.approx(prof["total_us_per_frame"], rel=1e-9)
    assert "== the same time in the JAX tool's buckets (us/frame) ==" in out
    assert sum(prof["stage_share"].values()) == pytest.approx(1.0, rel=1e-9)
    assert prof["launches_per_call"] is None and prof["card"] is None and prof["batch"] == 2
    assert len(prof["top_ops"]) == 2


def test_lm_world_and_costs_match_jax(sb, jax_runs):
    """The port's lm world from the JAX tool's numpy draws, and its costs.
    Measured gaps on the CPU, beside their tolerances: obs_uv 0.0 px (1e-3
    px); keyframe poses 0.0, landmark poses 3.05e-5, one float32 ulp of
    their 375-unit translations (1e-5 relative plus 1e-5); cost_initial
    2.0e-7 relative (1e-4); cost_single 4.3e-5 and cost_distributed 5.4e-5
    relative to the JAX line's rounded values (1e-2)."""
    args = sb.parse_args(LM + ["--device", "cpu"])
    st, K, P_max = sb.lm_world(args.landmarks, args.keyframes, args.obs)
    port = sb.lm_bench(args, (st, K, P_max))
    jline, jw = jax_runs.result("lm")
    for f in ("obs_kf", "obs_lm", "obs_ok"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), jw[f])
    np.testing.assert_allclose(st.obs_uv.numpy(), jw["obs_uv"], rtol=0, atol=1e-3)
    for f in ("kf_pose", "lm_pose"):
        np.testing.assert_allclose(getattr(st, f).numpy(), jw[f], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(K.numpy(), jw["K"], rtol=1e-6)
    assert LM_KEYS <= set(port)
    for k in ("landmarks", "keyframes", "observations", "max_obs_per_landmark", "lm_iters", "devices"):
        assert port[k] == jline[k], k
    assert port["cost_initial"] == pytest.approx(jline["cost_initial"], rel=1e-4)
    for k in ("cost_single", "cost_distributed"):
        assert port[k] == pytest.approx(jline[k], rel=0.01), (k, port[k], jline[k])
    assert port["flops_single"] > 0 and port["flops_distributed_per_device"] > 0


def test_kf_on_jax_problem_matches_jax(sb, jax_runs):
    """The kf mode on the JAX tool's own problem (carried across: the port
    cannot reproduce jax.random's bits). Measured gaps on the CPU, beside
    their tolerances: cost_initial 6.6e-8 relative (1e-4); cost_single
    1.3e-5 and cost_distributed 1.8e-5 relative to the JAX line's rounded
    values (1e-2); ate_initial 0.0045 su (0.01)."""
    jline, jp = jax_runs.result("kf")
    prob = keyframe_problem_from_jax_numpy({k: v for k, v in jp.items() if k not in ("kf_gt", "K")}, device="cpu")
    port = sb.kf_axis_bench(sb.parse_args(KF + ["--device", "cpu"]), (prob, jp["kf_gt"], jp["K"]))
    assert KF_KEYS <= set(port)
    for k in ("mode", "keyframes", "landmarks", "observations", "lm_iters", "cg_iters", "devices"):
        assert port[k] == jline[k], k
    assert port["cost_initial"] == pytest.approx(jline["cost_initial"], rel=1e-4)
    for k in ("cost_single", "cost_distributed"):
        assert port[k] == pytest.approx(jline[k], rel=0.01), (k, port[k], jline[k])
    assert port["ate_initial"] == pytest.approx(jline["ate_initial"], abs=0.01)
    assert port["ate_distributed"] < port["ate_initial"]
    assert 0 < port["work_scaling_efficiency"] <= 1.0



class _Event:
    """A stand-in for the profiler's raw event (``_KinetoEvent``)."""

    def __init__(self, name, start, end, corr=0, linked=0, cuda=False, annotation=False):
        from torch.autograd import DeviceType

        self._v = dict(name=name, start_ns=start, end_ns=end, correlation_id=corr, linked_correlation_id=linked,
                       device_type=DeviceType.CUDA if cuda else DeviceType.CPU, is_user_annotation=annotation,
                       start_thread_id=1)

    def __getattr__(self, k):
        return lambda: self._v[k]


def test_profile_attribution_of_device_events():
    """The CUDA path of the attribution (the CPU run above takes the other):
    a launch outside any op inside a stage range (the CCL kernel's),
    launches in nested back-end ranges, one outside every range, a device
    event without a runtime call, and the card-side copy of a range, which
    counts as no kernel; in the JAX tool's buckets, launches inside and
    outside the per-frame loop's range. Then the hook on the CPU:
    ``ba_add_frame``'s ops count in ``scan(per-frame)``, and the JAX buckets
    sum to the port's total."""
    tool = _load("profile_step_torch")
    ev = [
        _Event("stage_ccl", 100, 200, annotation=True),
        _Event("cudaLaunchKernel", 150, 160, corr=900),
        _Event("ccl_local", 300, 310, corr=900, cuda=True),
        _Event("stage_ccl", 300, 310, cuda=True, annotation=True),
        _Event("backend:ba(chunk)", 400, 600, annotation=True),
        _Event("backend:scan(per-frame)", 450, 500, annotation=True),
        _Event("aten::add", 460, 480, corr=5),
        _Event("cudaLaunchKernel", 465, 470, corr=901, linked=5),
        _Event("add_kernel", 700, 720, corr=901, linked=5, cuda=True),
        _Event("aten::mul", 550, 560, corr=6),
        _Event("cudaLaunchKernel", 552, 556, corr=902, linked=6),
        _Event("mul_kernel", 730, 760, corr=902, linked=6, cuda=True),
        _Event("aten::sub", 800, 810, corr=7),
        _Event("cudaMemcpyAsync", 801, 805, corr=903, linked=7),
        _Event("Memcpy DtoH", 900, 905, corr=903, linked=7, cuda=True),
        _Event("Memset", 910, 912, corr=904, cuda=True),
        _Event("jax:scan(per-frame)", 1000, 1100, annotation=True),
        _Event("backend:localize", 1010, 1020, annotation=True),
        _Event("cudaLaunchKernel", 1012, 1013, corr=905),
        _Event("gn_kernel", 1200, 1240, corr=905, cuda=True),
        _Event("cudaLaunchKernel", 1050, 1051, corr=906),
        _Event("where_kernel", 1250, 1253, corr=906, cuda=True),
        _Event("backend:localize", 1150, 1160, annotation=True),
        _Event("cudaLaunchKernel", 1152, 1153, corr=907),
        _Event("gn_kernel", 1300, 1350, corr=907, cuda=True),
    ]
    totals, examples, n, jax_totals = tool.attribute(ev, on_cuda=True)
    assert n == 8
    assert totals == pytest.approx({"ccl": 0.010, "scan(per-frame)": 0.020, "ba(chunk)": 0.030, "other": 0.010,
                                    "localize": 0.090})
    assert examples["ccl"] == pytest.approx({"ccl_local": 0.010})
    assert examples["other"] == pytest.approx({"Memcpy DtoH": 0.005, "Memset": 0.002, "where_kernel": 0.003})
    assert jax_totals == pytest.approx({"ccl": 0.010, "scan(per-frame)": 0.063, "ba(chunk)": 0.030,
                                        "other": 0.057})
    assert sum(jax_totals.values()) == pytest.approx(sum(totals.values()), rel=1e-12)

    from torch.profiler import ProfilerActivity, profile

    from aprilslam_tpu_torch.slam import ba_add_frame, ba_init

    state = ba_init(4, 8, 32, device="cpu")
    ids = torch.tensor([0, 3, -1], dtype=torch.int32)
    ok = torch.tensor([True, True, False])
    T = torch.eye(4).expand(3, 4, 4).clone()
    T[:, 2, 3] = 10.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tool.BackendRanges():
            added = ba_add_frame(state, ids, torch.rand(3, 4, 2) * 64, ok, torch.eye(4), T, seed_ok=ok)
    assert bool(added.lm_active[3])
    totals, examples, _n, jax_totals = tool.attribute(prof.profiler.kineto_results.events(), on_cuda=False)
    assert totals.get("scan(per-frame)", 0.0) > 0.0 and "ba(chunk)" not in totals, totals
    assert jax_totals["scan(per-frame)"] == pytest.approx(totals["scan(per-frame)"], rel=1e-12)
    assert sum(jax_totals.values()) == pytest.approx(sum(totals.values()), rel=1e-12)
