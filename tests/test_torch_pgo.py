"""Port parity: the camera pose graph (``slam/pgo.py``, ``slam/loop.py``)
against the JAX package.

``pgo_optimize`` and ``pgo_cost`` on random graphs; then a scripted run of
``pgo_track_frame`` that adopts nodes into a small ring (evicting tenants),
opens loop windows and mints loop edges, solved inline and at "chunk
boundaries" with ``pgo_solve``, with ``apply_node_deltas`` on the result.
Every frame restarts the port from the JAX state (carried across by
``convert.py``): integer and boolean state must match exactly, poses to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import se3_exp
from aprilslam_tpu.slam import loop as JLoop
from aprilslam_tpu.slam import pgo as JPgo
from aprilslam_tpu_torch import slam as TS
from aprilslam_tpu_torch.convert import _from_numpy, _to_numpy

EXACT = ("node_active", "node_seq", "node_ptr", "edge_ptr", "kf_node", "lm_node", "lm_ref",
         "lm_frame", "lm_loop_node", "lm_loop_until", "frame", "n_loops", "n_solved", "last_opt")


def jnp_state(x):
    if dataclasses.is_dataclass(x):
        return {f.name: jnp_state(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def to_port(cls, arrays):
    return _from_numpy(cls, arrays, torch.device("cpu"))


def random_poses(rng, n, rot=0.3, trans=5.0):
    xi = np.concatenate([rng.normal(scale=rot, size=(n, 3)),
                         rng.normal(scale=trans, size=(n, 3))], -1).astype(np.float32)
    with jax.enable_x64(False):
        return np.array(se3_exp(jnp.asarray(xi)))


def random_graph(rng, N=10, n_loops=3):
    """Drifted poses, exact odometry plus loop edges, some loop edges not ok
    (the odometry chain stays whole, so the gauge pins the whole graph)."""
    gt = random_poses(rng, N)
    drift = np.einsum("nij,njk->nik", gt, random_poses(rng, N, rot=0.02, trans=0.3))
    i = np.concatenate([np.arange(N - 1), rng.integers(0, N // 2, n_loops)]).astype(np.int32)
    j = np.concatenate([np.arange(1, N), rng.integers(N // 2, N, n_loops)]).astype(np.int32)
    T_meas = np.einsum("eij,ejk->eik", np.linalg.inv(gt[i]), gt[j]).astype(np.float32)
    weight = np.concatenate([np.ones(N - 1), np.full(n_loops, 4.0)]).astype(np.float32)
    ok = np.concatenate([np.ones(N - 1, bool), rng.random(n_loops) > 0.3])
    return drift.astype(np.float32), dict(i=i, j=j, T_meas=T_meas, weight=weight, ok=ok)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pgo_cost_and_optimize(seed):
    rng = np.random.default_rng(seed)
    poses, e = random_graph(rng)
    active = rng.random(len(poses)) > 0.2
    gauge = int(np.flatnonzero(active)[-1])
    with jax.enable_x64(False):
        je = JPgo.PoseGraphEdges(**{k: jnp.asarray(v) for k, v in e.items()})
        jc = float(JPgo.pgo_cost(jnp.asarray(poses), je))
        jo = np.asarray(JPgo.pgo_optimize(jnp.asarray(poses), je, active=jnp.asarray(active), iters=6))
        jg = np.asarray(JPgo.pgo_optimize(jnp.asarray(poses), je, iters=4, gauge_index=jnp.int32(gauge)))
    te = to_port(TS.PoseGraphEdges, e)
    tp = torch.as_tensor(poses)
    assert float(TS.pgo_cost(tp, te)) == pytest.approx(jc, rel=1e-4)
    np.testing.assert_allclose(TS.pgo_optimize(tp, te, active=torch.as_tensor(active), iters=6).numpy(),
                               jo, atol=1e-4)
    np.testing.assert_allclose(TS.pgo_optimize(tp, te, iters=4, gauge_index=torch.tensor(gauge)).numpy(),
                               jg, atol=1e-4)


def test_edges_from_trajectory_and_add_edge():
    rng = np.random.default_rng(3)
    poses = random_poses(rng, 6)
    with jax.enable_x64(False):
        je = JPgo.edges_from_trajectory(jnp.asarray(poses))
        je = JPgo.add_edge(JPgo.edges_init(8), 6, 5, 0, je.T_meas[2], weight=2.0)
    te = TS.edges_from_trajectory(torch.as_tensor(poses))
    te = TS.add_edge(TS.edges_init(8, device="cpu"), 6, 5, 0, te.T_meas[2], weight=2.0)
    for k, v in jnp_state(je).items():
        np.testing.assert_allclose(getattr(te, k).numpy(), v, atol=1e-6, err_msg=k)
    assert float(TS.pgo_cost(torch.as_tensor(poses), TS.edges_from_trajectory(torch.as_tensor(poses)))) < 1e-6


def _scripted_frames(n_frames=40, M=8):
    """Camera along x; tags on a row ahead. Tag 1 is seen early, lost, and
    re-seen (a loop window opens); tag 0 is seen at the start only and again
    once its partner node has been evicted from the ring; tag 2 is always in
    view. The camera's own pose estimate drifts, so loop edges carry signal.
    Every other frame is a node; frame 3k+1 has no reliable PnP for tag 2."""
    rng = np.random.default_rng(7)
    lm = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    lm[:, 0, 3] = 3.0 * np.arange(M)
    lm[:, 2, 3] = 40.0
    frames = []
    drift = np.eye(4, dtype=np.float32)
    for f in range(n_frames):
        T_true = np.eye(4, dtype=np.float32)
        T_true[0, 3] = 0.5 * f
        drift = drift @ random_poses(rng, 1, rot=0.002, trans=0.02)[0]
        tags = [2] + ([1] if f in (2, 3, 4, 14, 15, 16, 17, 18, 19) else []) + ([0] if f in (0, 1, 33, 34) else [])
        ids = np.full((4,), -1, np.int32)
        T_obs = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        ok = np.zeros((4,), bool)
        for k, m in enumerate(sorted(tags)):
            ids[k] = m
            T_obs[k] = np.linalg.inv(T_true) @ lm[m] @ random_poses(rng, 1, rot=0.003, trans=0.03)[0]
            ok[k] = not (m == 2 and f % 3 == 1)
        frames.append(dict(T_wc=(T_true @ drift).astype(np.float32), ids=ids, T_obs=T_obs.astype(np.float32),
                           ok=ok, is_node=f % 2 == 0 or bool(ok[ids == 1].any()), kf_slot=f % 5))
    return frames


@pytest.fixture(scope="module")
def tracked():
    """The JAX tracker over the scripted frames (inline solve), state by state."""
    P, E, M, K = 8, 24, 8, 4
    with jax.enable_x64(False):
        st = JLoop.pgo_init(P, E, M, K)
        states = [jnp_state(st)]
        outs = []
        for fr in _scripted_frames():
            st, delta, closed = JLoop.pgo_track_frame(
                st, jnp.asarray(fr["T_wc"]), jnp.asarray(True), jnp.asarray(fr["ids"]),
                jnp.asarray(fr["T_obs"]), jnp.asarray(fr["ok"]), jnp.asarray(fr["is_node"]),
                jnp.int32(fr["kf_slot"]), loop_gap=3, opt_iters=6)
            states.append(jnp_state(st))
            outs.append((np.asarray(delta), bool(closed)))
    return states, outs


def assert_pgo_state(got: "TS.PgoState", want: dict, atol=1e-4):
    for k in EXACT:
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k], err_msg=k)
    for k in ("i", "j", "ok"):
        np.testing.assert_array_equal(getattr(got.edges, k).numpy(), want["edges"][k], err_msg=k)
    np.testing.assert_allclose(got.edges.weight.numpy(), want["edges"]["weight"], err_msg="weight")
    for k, v in (("node_pose", want["node_pose"]), ("lm_obs_T", want["lm_obs_T"]),
                 ("lm_loop_T", want["lm_loop_T"]), ("T_meas", want["edges"]["T_meas"])):
        g = got.edges.T_meas if k == "T_meas" else getattr(got, k)
        np.testing.assert_allclose(g.numpy(), v, atol=atol, err_msg=k)


def test_track_frame_sequence(tracked):
    states, outs = tracked
    frames = _scripted_frames()
    final = states[-1]
    # The script reaches every branch: loops minted and solved, ring slots
    # evicted (more adoptions than slots), windows opened.
    assert int(final["n_loops"]) >= 2 and int(final["n_solved"]) == int(final["n_loops"])
    assert int(final["node_ptr"]) > 8
    assert any(c for _, c in outs)
    for f, fr in enumerate(frames):
        st = to_port(TS.PgoState, states[f])
        got, delta, closed = TS.pgo_track_frame(
            st, torch.as_tensor(fr["T_wc"]), torch.tensor(True), torch.as_tensor(fr["ids"]),
            torch.as_tensor(fr["T_obs"]), torch.as_tensor(fr["ok"]), torch.tensor(fr["is_node"]),
            torch.tensor(fr["kf_slot"], dtype=torch.int32), loop_gap=3, opt_iters=6)
        assert bool(closed) == outs[f][1], f
        assert_pgo_state(got, states[f + 1])
        np.testing.assert_allclose(delta.numpy(), outs[f][0], atol=1e-4, err_msg=f"delta {f}")


def test_deferred_solve_and_node_deltas(tracked):
    """Minting without a solve (the chunk schedule), then one pgo_solve over
    the pending edges, and the deltas applied to keyframe-like poses."""
    states, _ = tracked
    frames = _scripted_frames()
    with jax.enable_x64(False):
        st = JLoop.pgo_init(8, 24, 8, 4)
        for fr in frames[:20]:
            st, _, _ = JLoop.pgo_track_frame(
                st, jnp.asarray(fr["T_wc"]), jnp.asarray(True), jnp.asarray(fr["ids"]),
                jnp.asarray(fr["T_obs"]), jnp.asarray(fr["ok"]), jnp.asarray(fr["is_node"]),
                jnp.int32(fr["kf_slot"]), loop_gap=3, solve=False)
        pending = jnp_state(st)
        js, jdelta, jclosed = JLoop.pgo_solve(st, opt_iters=4)
        node_of = np.array([0, 3, -1, 7, 5], np.int32)
        T = random_poses(np.random.default_rng(9), 5)
        japplied = np.asarray(JLoop.apply_node_deltas(jdelta, jnp.asarray(node_of), jnp.asarray(T)))
    assert int(pending["n_loops"]) > int(pending["n_solved"])
    ts, tdelta, tclosed = TS.pgo_solve(to_port(TS.PgoState, pending), opt_iters=4)
    assert bool(tclosed) and bool(jclosed)
    assert_pgo_state(ts, jnp_state(js))
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), atol=1e-4)
    got = TS.apply_node_deltas(tdelta, torch.as_tensor(node_of), torch.as_tensor(T))
    np.testing.assert_allclose(got.numpy(), japplied, atol=1e-4)
    assert torch.equal(got[2], torch.as_tensor(T[2]))  # node_of < 0: unchanged


def test_solve_without_pending_loops_is_an_exact_passthrough(tracked):
    states, _ = tracked
    idle = next(s for s in states if int(s["node_ptr"]) > 3 and int(s["n_loops"]) == int(s["n_solved"]))
    st = to_port(TS.PgoState, idle)
    got, delta, closed = TS.pgo_solve(st, opt_iters=4)
    assert not bool(closed)
    assert torch.equal(got.node_pose, st.node_pose)
    assert torch.equal(delta, torch.eye(4).expand(8, 4, 4))
    T = torch.as_tensor(random_poses(np.random.default_rng(1), 8))
    assert torch.equal(TS.apply_node_deltas(delta, st.kf_node.repeat(2), T), T)
    # With solve=False the tracker returns the exact identity too.
    fr = _scripted_frames()[0]
    _, d0, c0 = TS.pgo_track_frame(
        st, torch.as_tensor(fr["T_wc"]), torch.tensor(True), torch.as_tensor(fr["ids"]),
        torch.as_tensor(fr["T_obs"]), torch.as_tensor(fr["ok"]), torch.tensor(True),
        torch.tensor(0, dtype=torch.int32), solve=False)
    assert not bool(c0) and torch.equal(d0, torch.eye(4).expand(8, 4, 4))


def test_convert_round_trip_pgo_state(tracked):
    states, _ = tracked
    want = states[-1]
    got = _to_numpy(to_port(TS.PgoState, want))
    assert got.keys() == want.keys() and got["edges"].keys() == want["edges"].keys()
    for k in want:
        sub = want[k] if isinstance(want[k], dict) else {k: want[k]}
        gsub = got[k] if isinstance(got[k], dict) else {k: got[k]}
        for kk in sub:
            assert gsub[kk].dtype == sub[kk].dtype, kk
            np.testing.assert_array_equal(gsub[kk], sub[kk], err_msg=kk)
