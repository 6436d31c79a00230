"""Worker of the multi-process kf-axis scaling curve (port of
``tools/scaling_proc_worker.py``).

Started N times by ``tools/scaling_bench_torch.py --mode kf-proc``. Each
process joins a ``torch.distributed`` group (``--platform gpu``: NCCL, one
card per rank; ``cpu``: gloo) and holds one shard of the keyframe axis, so
every ``psum`` and ring shift of the solver crosses processes. Every
process synthesizes the same problem. Rank 0 prints one JSON line:

* wall clock of the whole solve, best of ``--reps`` after a warm-up, and per
  LM iteration;
* collective-only time from a microbenchmark at the solver's payloads: per
  CG iteration one ``psum`` of (M, 6) floats and two ring shifts of 6
  floats, ``--cg-iters`` times;
* ATE before and after against the synthetic ground truth, each rank's
  keyframes summed across ranks.

    python3 tools/scaling_proc_worker_torch.py --num-processes 2 --process-id 0 --port 29512 --platform cpu &
    python3 tools/scaling_proc_worker_torch.py --num-processes 2 --process-id 1 --port 29512 --platform cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--keyframes", type=int, default=10240)
    ap.add_argument("--landmarks", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cg-iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from aprilslam_tpu_torch.parallel import (
        build_keyframe_ba, initialize_distributed, make_mesh, synthesize_trajectory_problem)
    from aprilslam_tpu_torch.parallel.keyframe_ba import KF_SHARDED
    from aprilslam_tpu_torch.parallel.multihost import all_processes_cost, make_global

    n, rank = args.num_processes, args.process_id
    if args.platform == "cpu":
        # One process per shard on a shared host: split its cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(f"localhost:{args.port}", num_processes=n, process_id=rank, platform=args.platform)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if args.platform == "gpu" else torch.device("cpu")
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        K, M = args.keyframes, args.landmarks
        prob, kf_gt, Kmat = synthesize_trajectory_problem(K, M, n, obs_per_kf=4, seed=7, device="cpu")
        O = int(prob.obs_kf.shape[0])
        mesh = make_mesh(n, axis="kf", device=dev, group=dist.group.WORLD)
        prob_l = type(prob)(**{f: make_global(mesh, "kf" if f in KF_SHARDED else None, getattr(prob, f))
                               for f in prob.__dataclass_fields__})
        Kmat = Kmat.to(dev)
        run = build_keyframe_ba(mesh, K, M, O, 10.0, iters=args.iters, cg_iters=args.cg_iters)

        out, cost = run(prob_l, Kmat)  # warm-up
        sync()
        t_best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out, cost = run(prob_l, Kmat)
            sync()
            t_best = min(t_best, time.perf_counter() - t0)

        # The solver's collectives at its per-CG payloads, cg_iters times.
        ax = mesh.axis("kf")

        def collectives(u, seam):
            for _ in range(args.cg_iters):
                u = ax.psum(u) * (1.0 / n)  # normalised: no overflow
                seam = ax.from_right(ax.from_right(seam))
                seam = seam + u[:, 0, :6]  # a data dependence between iterations
            return u, seam

        u0 = torch.ones((1, M, 6), device=dev)
        s0 = torch.ones((1, 6), device=dev)
        collectives(u0, s0)
        sync()
        t_coll = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            collectives(u0, s0)
            sync()
            t_coll = min(t_coll, time.perf_counter() - t0)

        Kl = K // n
        d = out.kf_pose[:, :3, 3].cpu().numpy() - kf_gt[rank * Kl:(rank + 1) * Kl, :3, 3]
        sse, cnt = float(np.sum(d * d)), d.shape[0]
        if n > 1:
            sse = float(all_processes_cost(sse).sum())
            cnt = int(all_processes_cost(float(cnt)).sum())
        e0 = prob.kf_pose[:, :3, 3].numpy() - kf_gt[:, :3, 3]
        if rank == 0:
            print(json.dumps({
                "processes": n,
                "keyframes": K, "landmarks": M, "observations": O,
                "lm_iters": args.iters, "cg_iters": args.cg_iters,
                "t_solve_s": t_best,
                "t_per_lm_iter_s": t_best / args.iters,
                "t_collectives_per_lm_iter_s": t_coll,
                "cost_final": cost,
                "ate_initial": float(np.sqrt(np.mean(np.sum(e0 * e0, axis=-1)))),
                "ate_final": float(np.sqrt(sse / max(cnt, 1))),
                "trajectory_span_su": float(np.ptp(kf_gt[:, :3, 3], axis=0).max()),
                "backend": dist.get_backend(),
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
