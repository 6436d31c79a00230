"""Two CPU processes joined by a gloo process group run the port's sharded
solvers with one shard per rank, and give what the same solvers give with
the two shards stacked in one process.

The file is also the worker: ``python tests/test_torch_multihost.py
--rank R --world 2 --port P`` joins the group and prints one JSON line.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = 10.0
K_LM, M_LM, O_LM = 8, 32, 256  # the landmark-axis problem (tests/multihost_worker.py's)
WALL_S = 120  # each worker's wall clock; init_process_group times out at 60 s


def _lm_state(seed: int = 100):
    """tests/multihost_worker.py's deterministic BA problem, on the port."""
    from dataclasses import replace

    from aprilslam_tpu_torch.geometry import PinholeCamera, se3_exp, tag_object_corners
    from aprilslam_tpu_torch.slam.ba import ba_init

    K, M, O = K_LM, M_LM, O_LM
    rng = np.random.default_rng(seed)
    Km = PinholeCamera.from_fov(800, 800, 50.0).matrix
    obj = tag_object_corners(TAG).numpy()
    side = int(np.ceil(np.sqrt(M)))
    lm_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    for m in range(M):
        lm_pose[m][:3, 3] = [(m % side) * 20.0, (m // side) * 20.0, 0.0]
    kf_pose = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    for k in range(K):
        kf_pose[k][:3, :3] = np.diag([1, -1, -1]).astype(np.float32)
        kf_pose[k][:3, 3] = [rng.uniform(0, side * 20), rng.uniform(0, side * 20), 120.0]
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
    noisy = lambda T: np.stack([  # noqa: E731
        se3_exp(torch.as_tensor(rng.normal(scale=0.01, size=6), dtype=torch.float32)).numpy() @ t for t in T])
    t = torch.as_tensor
    st = replace(ba_init(K, M, O, device="cpu"),
                 kf_pose=t(noisy(kf_pose)), kf_active=torch.ones(K, dtype=torch.bool),
                 lm_pose=t(noisy(lm_pose)), lm_active=torch.ones(M, dtype=torch.bool),
                 obs_kf=t(obs_kf), obs_lm=t(obs_lm), obs_uv=t(obs_uv), obs_ok=t(np.arange(O) < i))
    return st, t(Km)


def _solve(mesh_of, local):
    """Both solvers: the landmark-axis BA (8 iterations) and the
    keyframe-axis BA of a 64-keyframe trajectory (4 x 16), each on the
    2-shard mesh ``mesh_of(axis)``. ``local(mesh, axis, value)`` takes this
    process's part of a whole field (the whole of it in one process)."""
    from dataclasses import replace

    from aprilslam_tpu_torch.parallel import (
        build_distributed_ba, build_keyframe_ba, shard_observations_by_owner,
        synthesize_trajectory_problem)
    from aprilslam_tpu_torch.parallel.distributed_ba import LM_SHARDED
    from aprilslam_tpu_torch.parallel.keyframe_ba import KF_SHARDED

    st, Km = _lm_state()
    st = shard_observations_by_owner(st, 2)
    mesh = mesh_of("lm")
    st = replace(st, **{f: local(mesh, "lm", getattr(st, f)) for f in LM_SHARDED})
    _out, cost_lm = build_distributed_ba(mesh, K_LM, M_LM, O_LM, TAG, axis="lm", iters=8)(st, Km)
    prob, _gt, Kk = synthesize_trajectory_problem(64, 16, 2, obs_per_kf=3, seed=5, device="cpu")
    n_obs = int(prob.obs_kf.shape[0])
    mesh = mesh_of("kf")
    prob = replace(prob, **{f: local(mesh, "kf", getattr(prob, f)) for f in KF_SHARDED})
    out_kf, cost_kf = build_keyframe_ba(mesh, 64, 16, n_obs, TAG, iters=4, cg_iters=16)(prob, Kk)
    return cost_lm, cost_kf, out_kf


def worker(rank: int, world: int, port: int) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from aprilslam_tpu_torch.parallel import initialize_distributed, is_multiprocess, make_mesh
    from aprilslam_tpu_torch.parallel.multihost import all_processes_cost, make_global

    initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank, platform="cpu")
    try:
        assert is_multiprocess() and dist.get_backend() == "gloo"
        mesh_of = lambda axis: make_mesh(axis=axis, device="cpu", group=dist.group.WORLD)  # noqa: E731
        assert mesh_of("lm").backend == "process_group" and mesh_of("lm").shape == {"lm": world}
        cost_lm, cost_kf, out_kf = _solve(mesh_of, make_global)
        gathered = all_processes_cost(cost_lm + rank)
        print(json.dumps({"rank": rank, "cost_lm": cost_lm, "cost_kf": cost_kf,
                          "kf_rows": int(out_kf.kf_pose.shape[0]),
                          "finite": bool(torch.isfinite(out_kf.kf_pose).all()),
                          "gathered": gathered.tolist()}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_stacked():
    torch.set_num_threads(1)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", "2",
                               "--port", str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WALL_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{out}"
    res = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]) for out in outs]

    from aprilslam_tpu_torch.parallel import make_mesh

    cost_lm, cost_kf, out_kf = _solve(lambda axis: make_mesh(2, axis=axis, device="cpu"),
                                      lambda mesh, axis, v: v)
    for r, got in enumerate(res):
        assert got["rank"] == r and got["finite"] and got["kf_rows"] == 32
        assert abs(got["cost_lm"] - cost_lm) <= 1e-5 * cost_lm, (got["cost_lm"], cost_lm)
        assert abs(got["cost_kf"] - cost_kf) <= 1e-5 * cost_kf, (got["cost_kf"], cost_kf)
        # all_processes_cost orders the scalars by rank.
        np.testing.assert_allclose(got["gathered"], [res[0]["cost_lm"], res[1]["cost_lm"] + 1], rtol=1e-6)
    assert torch.isfinite(out_kf.kf_pose).all()


def test_initialize_distributed_refuses_unknown_platform():
    from aprilslam_tpu_torch.parallel import initialize_distributed, is_multiprocess

    with pytest.raises(ValueError, match="platform"):
        initialize_distributed("localhost:1", 1, 0, platform="tpu")
    assert not is_multiprocess()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    a = ap.parse_args()
    worker(a.rank, a.world, a.port)
