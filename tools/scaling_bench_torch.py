#!/usr/bin/env python3
"""Large-map distributed-BA scaling benchmark, BASELINE config 5 (port of
``tools/scaling_bench.py``): the same flags, defaults and JSON keys per mode.

* ``lm``: a grid of ``--landmarks`` tags seen by ``--keyframes`` keyframes
  (``--obs`` observations); LM-BA on one device with the sparse Schur
  coupling against the landmark-sharded solver at ``--devices`` shards.
* ``kf``: one trajectory of ``--keyframes`` keyframes over ``--landmarks``
  tags, the keyframe-axis solver at 1 and at ``--devices`` shards
  (config 5's long trajectory: ``--mode kf --keyframes 10240 --landmarks 256``).
* ``kf-proc``: the kf-axis solve at each count of ``--processes``, one
  shard per process of a ``torch.distributed`` group (``--platform gpu``:
  NCCL, one card per rank; ``cpu``: gloo), through
  ``tools/scaling_proc_worker_torch.py``; relays rank 0's line per count,
  then a summary line.

``--devices`` is the shard count, as in ``aprilslam-torch-refine``: the
shards are stacked on the one device (``parallel.collectives.StackedAxis``),
so ``speedup`` and ``scaling_efficiency_measured`` measure batching on one
device, not distribution. ``flops_*`` and ``work_scaling_efficiency`` come
from ``torch.utils.flop_counter.FlopCounterMode`` over the warm-up solve
(the JAX tool reads XLA's cost model); it counts matmul-family ops only, and a count
that fails is ``null``. ``--device`` is ``cuda`` (the default: exits 1
without a GPU) or ``cpu``; ``--platform`` defaults to it.

Usage:
  python3 tools/scaling_bench_torch.py --mode lm
  python3 tools/scaling_bench_torch.py --mode kf --keyframes 10240 --landmarks 256 --devices 8
  python3 tools/scaling_bench_torch.py --mode kf-proc --processes 1
  python3 tools/scaling_bench_torch.py --device cpu --mode lm --landmarks 256 --keyframes 16 --obs 1024 --devices 2
  python3 tools/scaling_bench_torch.py --device cpu --mode kf-proc --processes 1,2 --keyframes 2048 --landmarks 256
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAG_SIZE = 10.0
WORKER = os.path.join(ROOT, "tools", "scaling_proc_worker_torch.py")
STACKED_NOTE = ("--devices shards are stacked on one device (StackedAxis), so speedup and "
                "scaling_efficiency_measured measure batching on one device, not distribution; "
                "flops are torch.utils.flop_counter counts of matmul-family ops only over one solve "
                "(per device = counted / shards), not XLA's cost model")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--mode", choices=("lm", "kf", "kf-proc"), default="lm",
        help="lm: landmark-axis sharded window BA (big maps); kf: keyframe-axis sharded "
             "long-trajectory BA (10k keyframes); kf-proc: the same kf-axis solve at each "
             "--processes count, one shard per process of a torch.distributed group")
    ap.add_argument("--processes", type=str, default="1,2,4,8", help="kf-proc: comma-separated process counts")
    ap.add_argument("--landmarks", type=int, default=10240)
    ap.add_argument("--keyframes", type=int, default=64)
    ap.add_argument("--obs", type=int, default=16384)
    ap.add_argument("--devices", type=int, default=8, help="shards, stacked on the one device")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits 1 without a GPU) or cpu")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                    help="kf-proc: gpu (NCCL, one card per rank) or cpu (gloo); default: --device's")
    return ap.parse_args(argv)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, reps: int, dev: torch.device):
    """(fn's last result, mean seconds per call over ``reps`` calls, the
    flops of the warm-up call before them); each call synchronised."""
    flops = count_flops(fn)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        _sync(dev)
    return out, (time.perf_counter() - t0) / reps, flops


def count_flops(fn) -> float | None:
    """Matmul-family flops of one call of ``fn`` (FlopCounterMode); None
    where the count fails or finds nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as fc:
            fn()
        total = float(fc.get_total_flops())
    except Exception as e:  # noqa: BLE001 - any failure of the count is reported as null
        print(f"flop count failed: {type(e).__name__}: {e}", file=sys.stderr)
        return None
    return total or None


def lm_world(n_lm: int, n_kf: int, n_obs: int, seed: int = 0):
    """The landmark-axis world of ``tools/scaling_bench.py:71-137``: a square
    grid of ``n_lm`` tags 25 units apart, ``n_kf`` keyframes looking down
    from 140 units at random spots, each observing its ``n_obs / n_kf``
    nearest tags with 0.3 px corner noise, and keyframes and tags perturbed
    by se3_exp of 0.01-sigma noise, from the JAX tool's numpy draws in its
    order. Returns (BAState on the CPU, Kmat, the largest observation count
    of one landmark)."""
    from aprilslam_tpu_torch.geometry import PinholeCamera, se3_exp, tag_object_corners
    from aprilslam_tpu_torch.slam import ba_init

    rng = np.random.default_rng(seed)
    M, K, O = n_lm, n_kf, n_obs
    Km = PinholeCamera.from_fov(1000, 1000, 45.0).matrix
    obj = tag_object_corners(TAG_SIZE).numpy()
    side = int(np.ceil(np.sqrt(M)))
    lm_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    lm_pose[:, 0, 3] = (np.arange(M) % side) * 25.0
    lm_pose[:, 1, 3] = (np.arange(M) // side) * 25.0
    kf_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    for k in range(K):
        kf_pose[k][:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
        kf_pose[k][:3, 3] = [rng.uniform(0, side * 25), rng.uniform(0, side * 25), 140.0]
    obs_kf, obs_lm = np.zeros(O, np.int32), np.zeros(O, np.int32)
    obs_uv = np.zeros((O, 4, 2), np.float32)
    i = 0
    for k in range(K):
        d = np.linalg.norm(lm_pose[:, :3, 3] - kf_pose[k][:3, 3], axis=-1)
        for m in np.argsort(d)[:O // K]:
            T_ct = np.linalg.inv(kf_pose[k]) @ lm_pose[m]
            p = obj @ T_ct[:3, :3].T + T_ct[:3, 3]
            uv = p[:, :2] / p[:, 2:3]
            obs_uv[i] = np.stack([Km[0, 0] * uv[:, 0] + Km[0, 2], Km[1, 1] * uv[:, 1] + Km[1, 2]], -1) \
                + rng.normal(scale=0.3, size=(4, 2))
            obs_kf[i], obs_lm[i] = k, m
            i += 1

    def noisy(T):
        xi = torch.as_tensor(np.stack([rng.normal(scale=0.01, size=6) for _ in range(len(T))]), dtype=torch.float32)
        return (se3_exp(xi).numpy() @ T).astype(np.float32)

    kf_noisy, lm_noisy = noisy(kf_pose), noisy(lm_pose)
    t = torch.as_tensor
    st = replace(ba_init(K, M, O, device="cpu"),
                 kf_pose=t(kf_noisy), kf_active=torch.ones(K, dtype=torch.bool),
                 lm_pose=t(lm_noisy), lm_active=torch.ones(M, dtype=torch.bool),
                 obs_kf=t(obs_kf), obs_lm=t(obs_lm), obs_uv=t(obs_uv), obs_ok=t(np.arange(O) < i),
                 anchor=torch.tensor(0, dtype=torch.int32), kf_ptr=torch.tensor(K, dtype=torch.int32))
    return st, t(Km), int(np.bincount(obs_lm[:i], minlength=M).max())


def lm_solvers(args, st, Kmat, P_max: int):
    """The two solves of the lm mode on ``st``'s device: (single, sharded),
    each a call with no arguments. ``single`` is ``ba_optimize`` with the
    sparse Schur coupling (``scaling_bench.py:148-155``: the efficiency
    isolates distribution, not an algorithm swap) and returns its BAState;
    ``sharded`` the landmark-sharded solver at ``args.devices`` shards on
    observation blocks grown to fit, returning (BAState, cost)."""
    from aprilslam_tpu_torch.parallel import build_distributed_ba, make_mesh, shard_observations_by_owner
    from aprilslam_tpu_torch.slam import ba_optimize

    dev = st.kf_pose.device
    st_sh = shard_observations_by_owner(st, args.devices, fit=True)
    run = build_distributed_ba(make_mesh(args.devices, axis="lm", device=dev), st.n_keyframes, st.n_landmarks,
                               st_sh.n_obs_capacity, TAG_SIZE, iters=args.iters, max_obs_per_lm=P_max)
    return (lambda: ba_optimize(st, Kmat, TAG_SIZE, iters=args.iters, coupling="sparse", max_obs_per_lm=P_max),
            lambda: run(st_sh, Kmat))


def lm_bench(args, world=None) -> dict:
    """The lm mode's line (``scaling_bench.py:53-207``); ``world`` is an
    optional (BAState, Kmat, P_max) to solve in place of ``lm_world``'s."""
    from aprilslam_tpu_torch.device import resolve_device
    from aprilslam_tpu_torch.slam import ba_cost

    dev = resolve_device(args.device)
    st, Kmat, P_max = world or lm_world(args.landmarks, args.keyframes, args.obs)
    st = replace(st, **{f: getattr(st, f).to(dev) for f in st.__dataclass_fields__})
    Kmat = Kmat.to(dev)
    n, n_obs = args.devices, int(st.obs_ok.sum())
    c0 = float(ba_cost(st, Kmat, TAG_SIZE))
    single, sharded = lm_solvers(args, st, Kmat, P_max)
    st1, t1, f1 = timed(single, args.reps, dev)
    (stn, _), tn, fn = timed(sharded, args.reps, dev)
    fd = fn / n if fn else None
    work_eff = f1 / fn if f1 and fn else None
    speedup = t1 / tn
    return {
        "landmarks": st.n_landmarks, "keyframes": st.n_keyframes, "observations": n_obs,
        "max_obs_per_landmark": P_max,
        "lm_iters": args.iters,
        "cost_initial": c0,
        "cost_single": float(ba_cost(st1, Kmat, TAG_SIZE)),
        "cost_distributed": float(ba_cost(stn, Kmat, TAG_SIZE)),
        "t_single_s": t1,
        "t_distributed_s": tn,
        "devices": n,
        "speedup": speedup,
        "scaling_efficiency_measured": speedup / n,
        "flops_single": f1,
        "flops_distributed_per_device": fd,
        "work_scaling_efficiency": work_eff,
        "ba_iters_per_sec_distributed": args.iters / tn,
        "device": device_name(dev),
        "note": STACKED_NOTE + "; work_scaling_efficiency = single flops / (shards * per-device flops)",
    }


def kf_solvers(args, prob, Kmat):
    """The two solves of the kf mode: the keyframe-axis solver at 1 and at
    ``args.devices`` shards on the same problem (its observations
    partitioned for ``args.devices`` shards), each a call with no
    arguments returning (problem, cost)."""
    from aprilslam_tpu_torch.parallel import build_keyframe_ba, make_mesh

    dev = prob.kf_pose.device
    K, M, O = prob.n_keyframes, prob.n_landmarks, int(prob.obs_kf.shape[0])
    runs = [build_keyframe_ba(make_mesh(n, axis="kf", device=dev), K, M, O, TAG_SIZE,
                              iters=args.iters, cg_iters=args.cg_iters) for n in (1, args.devices)]
    return tuple((lambda run=run: run(prob, Kmat)) for run in runs)


def kf_problem(args, problem=None):
    """(problem, kf_gt, Kmat) on ``args.device``: ``problem`` carried over
    (as the JAX tool built it), else ``synthesize_trajectory_problem`` at
    the JAX tool's settings (4 observations per keyframe, seed 7)."""
    from aprilslam_tpu_torch.device import resolve_device
    from aprilslam_tpu_torch.parallel import synthesize_trajectory_problem

    dev = resolve_device(args.device)
    if problem is None:
        return synthesize_trajectory_problem(args.keyframes, args.landmarks, args.devices, obs_per_kf=4, seed=7,
                                             device=dev)
    prob, kf_gt, Kmat = problem
    return (replace(prob, **{f: getattr(prob, f).to(dev) for f in prob.__dataclass_fields__}),
            np.asarray(kf_gt), torch.as_tensor(Kmat, device=dev))


def kf_axis_bench(args, problem=None) -> dict:
    """The kf mode's line (``scaling_bench.py:283-384``); ``problem`` is an
    optional (KeyframeBAProblem, kf_gt, Kmat) to solve in place of the
    synthesized one."""
    from aprilslam_tpu_torch.parallel import keyframe_ba_cost

    prob, kf_gt, Kmat = kf_problem(args, problem)
    dev = prob.kf_pose.device
    n = args.devices
    c0 = float(keyframe_ba_cost(prob, Kmat, TAG_SIZE))
    run1, runn = kf_solvers(args, prob, Kmat)
    (p1, _), t1, f1 = timed(run1, args.reps, dev)
    (pn, _), tn, fn = timed(runn, args.reps, dev)
    raw = f1 / fn if f1 and fn else None
    speedup = t1 / tn

    def ate(p) -> float:
        e = p.kf_pose[:, :3, 3].cpu().numpy() - kf_gt[:, :3, 3]
        return float(np.sqrt(np.mean(np.sum(e * e, axis=-1))))

    return {
        "mode": "kf-axis",
        "keyframes": prob.n_keyframes, "landmarks": prob.n_landmarks, "observations": int(prob.obs_kf.shape[0]),
        "lm_iters": args.iters, "cg_iters": args.cg_iters,
        "cost_initial": c0,
        "cost_single": float(keyframe_ba_cost(p1, Kmat, TAG_SIZE)),
        "cost_distributed": float(keyframe_ba_cost(pn, Kmat, TAG_SIZE)),
        "ate_initial": ate(prob),
        "ate_distributed": ate(pn),
        "trajectory_span_su": float(np.ptp(kf_gt[:, :3, 3], axis=0).max()),
        "t_single_s": t1,
        "t_distributed_s": tn,
        "devices": n,
        "speedup": speedup,
        "scaling_efficiency_measured": speedup / n,
        "work_scaling_efficiency": min(1.0, raw) if raw else None,
        "work_scaling_efficiency_raw": raw,
        "device": device_name(dev),
        "note": "one trajectory sharded over the kf axis; psum payload per CG iteration = 6*landmarks "
                "floats, independent of trajectory length; efficiency = same-builder 1-shard flops / "
                "(n * per-shard flops), clamped to <=1; ATE at this shallow iteration budget is a "
                "throughput config, not the converged accuracy; " + STACKED_NOTE,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def kf_proc_bench(args, wall_s: float = 1800.0) -> dict:
    """The kf-proc mode (``scaling_bench.py:210-280``): for each count in
    ``args.processes``, that many worker processes joined on a free port;
    prints rank 0's line per count (a failed count as an error row naming
    it), then the summary line. Returns {"rows", "summary", "failed"}.

    ``--platform gpu`` refuses a count above the visible cards before any
    worker starts. Workers still running after ``wall_s`` are killed and
    their count fails."""
    platform = args.platform or ("gpu" if args.device == "cuda" else "cpu")
    counts = [int(x) for x in args.processes.split(",")]
    if platform == "gpu" and max(counts) > torch.cuda.device_count():
        raise ValueError(f"--platform gpu needs one card per process: {max(counts)} processes, "
                         f"{torch.cuda.device_count()} visible cards")
    ncpu = os.cpu_count() or 1
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    rows, failed = [], []
    for n in counts:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, WORKER, "--num-processes", str(n), "--process-id", str(i), "--port", str(port),
             "--platform", platform, "--keyframes", str(args.keyframes), "--landmarks", str(args.landmarks),
             "--iters", str(args.iters), "--cg-iters", str(args.cg_iters), "--reps", str(args.reps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT) for i in range(n)]
        outs = []
        try:
            deadline = time.monotonic() + wall_s
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
                except subprocess.TimeoutExpired:
                    outs.append(f"killed after {wall_s} s")
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        rcs = [p.returncode for p in procs]
        line = next((ln for ln in outs[0].splitlines() if ln.startswith("{")), None)
        if any(rcs) or line is None:
            row = {"processes": n, "error": "worker failed", "rcs": rcs, "tail": outs[0][-800:]}
            failed.append(n)
            print(json.dumps(row), flush=True)
            continue
        row = json.loads(line)
        row["oversubscribed"] = n > ncpu
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = None
    if rows:
        base = rows[0]["t_per_lm_iter_s"]
        summary = {
            "summary": "kf-proc scaling",
            "platform": platform,
            "host_cpus": ncpu,
            "per_lm_iter_s": {str(r["processes"]): r["t_per_lm_iter_s"] for r in rows},
            "collectives_per_lm_iter_s": {str(r["processes"]): r["t_collectives_per_lm_iter_s"] for r in rows},
            "speedup_vs_1proc": {str(r["processes"]): base / r["t_per_lm_iter_s"] for r in rows},
            "failed_processes": failed,
            "note": f"host has {ncpu} CPU cores; with --platform cpu points beyond that are oversubscribed "
                    "and measure scheduler overhead, not sharding quality",
        }
        print(json.dumps(summary), flush=True)
    return {"rows": rows, "summary": summary, "failed": failed}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode == "kf-proc":
        return 1 if kf_proc_bench(args)["failed"] else 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    line = lm_bench(args) if args.mode == "lm" else kf_axis_bench(args)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
