"""Port parity: SLAM core (graph, localization, BA) and the whole headline
step against the JAX package.

The step is compared chunk by chunk: integer and boolean outputs exactly,
poses to a tolerance. LM accept tests, the dual-branch pick and the keyframe
policy are float comparisons, so one ulp can flip a frame; the chunk-2
comparison therefore also restarts from the reference's own state (carried
across by ``convert.py``), so drift cannot compound across chunks.
"""

import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chain_graph_cases import SHAPES, chain_chunk, compare_scans

from aprilslam_tpu.detect import DetectorParams
from aprilslam_tpu.geometry import PinholeCamera, se3_exp
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu.slam import ba as JB
from aprilslam_tpu.slam import build_slam_step
from aprilslam_tpu.slam import graph as JG
from aprilslam_tpu.slam import localize as JL
from aprilslam_tpu_torch import detect as TD
from aprilslam_tpu_torch import geometry as TG
from aprilslam_tpu_torch import slam as TS
from aprilslam_tpu_torch.convert import state_from_jax_numpy, state_to_numpy
from aprilslam_tpu_torch.eval import ate_eval
from aprilslam_tpu_torch.ops import chain_graph as chain_graph_op
from aprilslam_tpu_torch.sim import SceneConfig as TSceneConfig

ROOT = Path(__file__).resolve().parents[1]
RES, B, N_CHUNKS = 384, 4, 3
HEADLINE = dict(estimator="ba", ba_schedule="chunk", graph_capacity=16, ba_keyframes=16,
                ba_obs=512, init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3)
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
OUT_INTS = ("valid", "coord_id", "n_visible", "n_nodes", "loc_used", "node_visible",
            "det_ids", "det_ok", "loop_closures")


def t(x):
    return torch.as_tensor(np.array(x))


def to_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def random_poses(rng, n, scale=1.0):
    xi = np.concatenate([rng.normal(scale=0.3, size=(n, 3)),
                         rng.normal(scale=5.0 * scale, size=(n, 3))], -1).astype(np.float32)
    with jax.enable_x64(False):
        return np.array(se3_exp(jnp.asarray(xi)))


def assert_state_close(got, want, atol=1e-4):
    for k, v in want.items():
        g = getattr(got, k).numpy()
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            np.testing.assert_allclose(g, v, atol=atol, rtol=1e-4, err_msg=k)


# The frames of test_update_graph_sequence: (ids, ok), 3 slots each.
GRAPH_SEQUENCE = [([3, 5, -1], [1, 1, 0]), ([1, 3, 7], [1, 1, 1]), ([7, 9, -1], [1, 1, 0]),
                  ([0, 5, 9], [0, 1, 1]), ([2, 5, 11], [1, 1, 1]), ([-1, -1, -1], [0, 0, 0])]


def test_update_graph_sequence():
    """Chaining, multi-hop, keep-world and re-anchoring from identical states."""
    rng = np.random.default_rng(0)
    with jax.enable_x64(False):
        js = JG.init_graph(16)
    ts = TS.init_graph(16, device="cpu")
    for ids, ok in GRAPH_SEQUENCE:
        ids = np.asarray(ids, np.int32)
        ok = np.asarray(ok, bool)
        T = random_poses(rng, 3)
        with jax.enable_x64(False):
            js = JG.update_graph(js, jnp.asarray(ids), jnp.asarray(T), jnp.asarray(ok))
            jT, jv, js = JG.estimate_pose_average(js)
            jd = JG.average_distance_to_nodes(js)
        ts = TS.update_graph(ts, t(ids), t(T), t(ok))
        tT, tv, ts = TS.estimate_pose_average(ts)
        assert bool(tv) == bool(jv)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
        np.testing.assert_allclose(float(TS.average_distance_to_nodes(ts)), float(jd), rtol=1e-5)
        assert_state_close(ts, to_numpy(js))
    assert int(ts.coordinate_id) == 1


def frame_loop(state, ids, T, ok, project_rotation):
    """``update_graph`` then ``estimate_pose_average`` frame by frame, as the
    step ran them before the chunk's scan."""
    outs = []
    for b in range(ids.shape[0]):
        state = TS.update_graph(state, ids[b], T[b], ok[b])
        T_avg, valid, state = TS.estimate_pose_average(state, project_rotation=project_rotation)
        outs.append(dict(avg_T=T_avg, valid=valid, visible=state.visible, present=state.present,
                         weight=state.weight, local=state.local, world=state.world,
                         coordinate_id=state.coordinate_id, n_visible=state.visible.sum(),
                         n_nodes=state.present.sum(), avg_node_distance=TS.average_distance_to_nodes(state)))
    return state, TS.GraphScan(**{k: torch.stack([o[k] for o in outs]) for k in outs[0]})


@pytest.mark.parametrize("project_rotation", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_D{}_M{}".format(*s))
@pytest.mark.parametrize("seed", [0, 2, 7])
def test_scan_chain_graph_equals_frame_loop(shape, seed, project_rotation):
    """Two chunks in a row (the first re-anchors mid-chunk, seeds 0 and 2
    once with no known tag to chain through; empty frames, slots not ok, ids
    out of range): the scan's final state and every frame's results equal
    the per-frame loop's."""
    B, D, M = shape
    state = TS.init_graph(M, device="cpu")
    for c in (seed, seed + 100):
        chunk = tuple(torch.as_tensor(x) for x in chain_chunk(c, B, D, M))
        before = chain_graph_op.chain_graph_launches
        got = TS.scan_chain_graph(state, *chunk, project_rotation=project_rotation)
        assert chain_graph_op.chain_graph_launches == before
        assert compare_scans(got, frame_loop(state, *chunk, project_rotation)) <= 1e-6
        state = got[0]


def test_scan_chain_graph_matches_jax_sequence():
    """test_update_graph_sequence's frames fed as one chunk: the final state,
    each frame's average and node distance equal the JAX package's."""
    rng = np.random.default_rng(0)
    ids = np.asarray([f[0] for f in GRAPH_SEQUENCE], np.int32)
    ok = np.asarray([f[1] for f in GRAPH_SEQUENCE], bool)
    T = np.stack([random_poses(rng, 3) for _ in GRAPH_SEQUENCE])
    want_T, want_valid, want_d = [], [], []
    with jax.enable_x64(False):
        js = JG.init_graph(16)
        for b in range(len(GRAPH_SEQUENCE)):
            js = JG.update_graph(js, jnp.asarray(ids[b]), jnp.asarray(T[b]), jnp.asarray(ok[b]))
            jT, jv, js = JG.estimate_pose_average(js)
            want_T.append(np.asarray(jT))
            want_valid.append(bool(jv))
            want_d.append(float(JG.average_distance_to_nodes(js)))
    ts, scan = TS.scan_chain_graph(TS.init_graph(16, device="cpu"), t(ids), t(T), t(ok))
    assert_state_close(ts, to_numpy(js))
    np.testing.assert_allclose(scan.avg_T.numpy(), np.stack(want_T), atol=1e-4)
    np.testing.assert_array_equal(scan.valid.numpy(), want_valid)
    np.testing.assert_allclose(scan.avg_node_distance.numpy(), want_d, rtol=1e-5)
    assert int(ts.coordinate_id) == 1


def _kernel_args(M=16, B=2, D=4):
    s = TS.init_graph(M, device="cpu")
    ids, T, ok = (torch.as_tensor(x) for x in chain_chunk(0, B, D, M))
    return dict(local=s.local, world=s.world, weight=s.weight, present=s.present, updated=s.updated,
                reference=s.reference, coordinate_id=s.coordinate_id, has_estimate=s.has_estimate,
                ids=ids, T_cam_tag=T, ok=ok)


@pytest.mark.parametrize("bad, match", [
    (dict(ids=lambda a: a.long()), "ids as a contiguous .* torch.int32"),
    (dict(T_cam_tag=lambda a: a.double()), "T_cam_tag as a contiguous .* torch.float32"),
    (dict(T_cam_tag=lambda a: a.transpose(-1, -2)), "contiguous=False"),
    (dict(ok=lambda a: a[:, :2]), "ok as a contiguous"),
    (dict(reference=lambda a: a.long()), "reference as a contiguous"),
    (dict(ids=lambda a: a[:0]), "B >= 1"),
    ({}, "CUDA tensors"),
], ids=["ids-int64", "T-float64", "T-strided", "ok-shape", "reference-int64", "no-frames", "cpu"])
def test_chain_graph_wrapper_refuses(bad, match):
    """The kernel's wrapper checks dtypes, shapes and contiguity before the
    device, and takes CUDA tensors only."""
    args = _kernel_args()
    for k, f in bad.items():
        args[k] = f(args[k])
    before = chain_graph_op.chain_graph_launches
    with pytest.raises(ValueError, match=match):
        chain_graph_op.chain_graph_scan(**args)
    assert chain_graph_op.chain_graph_launches == before


def test_chain_graph_wrapper_refuses_capacity():
    with pytest.raises(ValueError, match="slots"):
        chain_graph_op.chain_graph_scan(**_kernel_args(M=chain_graph_op.MAX_CAPACITY + 1))


def test_scan_chain_graph_refuses_shapes():
    s = TS.init_graph(16, device="cpu")
    ids, T, ok = (torch.as_tensor(x) for x in chain_chunk(0, 2, 4, 16))
    for args in ((ids[0], T[0], ok[0]), (ids, T[..., :3, :], ok), (ids, T, ok[:1]), (ids[:0], T[:0], ok[:0])):
        with pytest.raises(ValueError, match="a chunk takes"):
            TS.scan_chain_graph(s, *args)


def _localization_problem(seed):
    rng = np.random.default_rng(seed)
    M, tag = 16, 10.0
    cam = PinholeCamera.from_fov(640, 480, 45.0)
    world = random_poses(rng, M, scale=3.0)
    T_wc = random_poses(rng, 1, scale=1.0)[0]
    T_wc[:3, 3] += np.array([0.0, 0.0, -120.0], np.float32)  # tags ahead of the camera
    T_cw = np.linalg.inv(T_wc).astype(np.float32)
    obj = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32)
    Xw = np.einsum("mij,cj->mci", world[:, :3, :3], obj) + world[:, None, :3, 3]
    Xc = np.einsum("ij,mcj->mci", T_cw[:3, :3], Xw) + T_cw[:3, 3]
    K = cam.matrix
    uv = (Xc[..., :2] / Xc[..., 2:3]) * K[0, 0] + K[:2, 2]
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    use = np.zeros(M, bool)
    use[rng.choice(M, 4, replace=False)] = True
    init = (random_poses(rng, 1, scale=0.05)[0] @ T_wc).astype(np.float32)
    return world, use, uv, K, tag, init


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_joint_camera_pose_and_observability(seed):
    world, use, uv, K, tag, init = _localization_problem(seed)
    with jax.enable_x64(False):
        jT, jr = jax.device_get(JL.joint_camera_pose(*map(jnp.asarray, (world, use, uv, K)), tag,
                                                     jnp.asarray(init), iters=6))
        js = float(JL.pose_observability(*map(jnp.asarray, (world, use, K)), tag, jnp.asarray(jT)))
    tT, tr = TS.joint_camera_pose(t(world), t(use), t(uv), t(K), tag, t(init), iters=6)
    dT, dr = TS.joint_camera_pose(t(world).double(), t(use), t(uv).double(), t(K).double(), tag,
                                  t(init).double(), iters=6)
    # Both float32 solves are held to the float64 optimum. With the tags ~120
    # units away the cost is flat along depth-coupled directions, so a float32
    # LM may stop a few 1e-3 units from the optimum: the reference does so on
    # seed 2 (4.8e-3 off, the port 1.7e-5), which a direct port-vs-reference
    # bound of 2e-3 would blame on the port. The cost itself agrees to 1e-4.
    np.testing.assert_allclose(tT.numpy(), dT.numpy(), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(jT, dT.numpy(), atol=1e-2, rtol=1e-4)
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-4)
    np.testing.assert_allclose(float(tr), float(dr), rtol=1e-4)
    ts = float(TS.pose_observability(t(world), t(use), t(K), tag, t(jT)))
    # sigma_min comes from a float32 eigvalsh of J^T J, which resolves the
    # smallest eigenvalue only to ~eps * lambda_max (a distant tag makes that
    # a few percent of sigma_min): both sides are held to the float64 value.
    t64 = float(TS.pose_observability(t(world).double(), t(use), t(K).double(), tag,
                                      t(jT).double()))
    np.testing.assert_allclose(ts, t64, rtol=0.1)
    np.testing.assert_allclose(js, t64, rtol=0.1)
    assert float(TS.pose_observability(t(world), t(np.zeros_like(use)), t(K), tag, t(jT))) == 0.0


def _ba_reference_state(rng, n_frames=6):
    """A BA state built by the JAX package from noisy synthetic observations."""
    M, K_slots, tag = 16, 8, 10.0
    cam = PinholeCamera.from_fov(640, 480, 45.0)
    K = cam.matrix
    lm_true = random_poses(rng, M, scale=3.0)
    obj = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32)
    with jax.enable_x64(False):
        st = JB.ba_init(K_slots, M, 64)
        for f in range(n_frames):
            T_wc = random_poses(rng, 1, scale=0.5)[0]
            T_wc[:3, 3] += np.array([0.0, 0.0, -120.0], np.float32)
            ids = np.sort(rng.choice(6, 3, replace=False)).astype(np.int32)
            T_ct = np.linalg.inv(T_wc) @ lm_true[ids]
            p = np.einsum("dij,cj->dci", T_ct[:, :3, :3], obj) + T_ct[:, None, :3, 3]
            uv = (p[..., :2] / p[..., 2:3]) * K[0, 0] + K[:2, 2]
            uv = (uv + rng.normal(scale=0.5, size=uv.shape)).astype(np.float32)
            noisy_wc = (random_poses(rng, 1, scale=0.02)[0] @ T_wc).astype(np.float32)
            noisy_ct = np.einsum("dij,djk->dik", random_poses(rng, 3, scale=0.02), T_ct).astype(np.float32)
            st = JB.ba_add_frame(st, jnp.asarray(ids), jnp.asarray(uv), jnp.ones(3, bool),
                                 jnp.asarray(noisy_wc), jnp.asarray(noisy_ct))
    return st, K, tag


def test_ba_add_frame_and_optimize_from_identical_state():
    rng = np.random.default_rng(4)
    jst, K, tag = _ba_reference_state(rng)
    g = to_numpy(JG.init_graph(16))
    _, tst = state_from_jax_numpy(g, to_numpy(jst), device="cpu")
    # ba_add_frame on the same inputs
    ids = np.array([1, 2, 7, -1], np.int32)
    ok = np.array([1, 1, 1, 0], bool)
    seed = np.array([1, 0, 1, 0], bool)
    uv = rng.uniform(0, 480, size=(4, 4, 2)).astype(np.float32)
    T_wc = random_poses(rng, 1)[0]
    T_ct = random_poses(rng, 4)
    with jax.enable_x64(False):
        jadd = JB.ba_add_frame(jst, *map(jnp.asarray, (ids, uv, ok, T_wc, T_ct)), seed_ok=jnp.asarray(seed))
    tadd = TS.ba_add_frame(tst, *map(t, (ids, uv, ok, T_wc, T_ct)), seed_ok=t(seed))
    assert_state_close(tadd, to_numpy(jadd), atol=1e-5)

    with jax.enable_x64(False):
        jopt = JB.ba_optimize(jst, jnp.asarray(K), tag, iters=4)
        jcost = float(JB.ba_cost(jopt, jnp.asarray(K), tag))
        jopt = jax.device_get(jopt)
    topt = TS.ba_optimize(tst, t(K), tag, iters=4)
    assert float(topt.lam) == pytest.approx(float(jopt.lam), rel=1e-6)  # same accept decisions
    np.testing.assert_allclose(float(TS.ba_cost(topt, t(K), tag)), jcost, rtol=1e-2)
    # The world gauge is held only by damping; compare gauge-free quantities:
    # every landmark and keyframe relative to the anchor landmark.
    a = int(jopt.anchor)
    lm_a = np.linalg.inv(jopt.lm_pose[a])
    act = jopt.lm_active
    np.testing.assert_allclose(np.linalg.inv(topt.lm_pose[a].numpy()) @ topt.lm_pose.numpy()[act],
                               lm_a @ jopt.lm_pose[act], atol=2e-2)
    kact = jopt.kf_active
    np.testing.assert_allclose(np.linalg.inv(topt.lm_pose[a].numpy()) @ topt.kf_pose.numpy()[kact],
                               lm_a @ jopt.kf_pose[kact], atol=5e-2)


def test_convert_round_trip():
    rng = np.random.default_rng(5)
    jst, _, _ = _ba_reference_state(rng, n_frames=2)
    g, b = to_numpy(JG.init_graph(16)), to_numpy(jst)
    g2, b2 = state_to_numpy(state_from_jax_numpy(g, b, device="cpu"))
    for want, got in ((g, g2), (b, b2)):
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def run():
    """The headline step, JAX and port, over the same rendered chunks."""
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    traj = trajectory.scripted_line(B * N_CHUNKS, np.array([0.0, 0.0, 20.0]), np.array([8.0, 2.0, -10.0]))
    with jax.enable_x64(False):
        frames = render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                               jnp.asarray(traj.rotations), jnp.asarray(cam.inv_matrix), RES, RES, 2)
        u8 = np.asarray(jnp.clip(frames * 255.0, 0, 255).astype(jnp.uint8))
        step, init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=PARAMS,
                                     **HEADLINE)
        step = jax.jit(step)
        state = init()
        j_outs, j_states = [], []
        for c in range(N_CHUNKS):
            state, o = step(state, jnp.asarray(u8[c * B:(c + 1) * B]))
            j_outs.append(jax.device_get(o))
            j_states.append(tuple(to_numpy(s) for s in state))
    tcam = TG.PinholeCamera(**cam.__dict__)
    tparams = TD.DetectorParams(**PARAMS.__dict__)
    slam = TS.SlamSystem(tcam, cfg.family, cfg.tag_size_inner, detector_params=tparams,
                         device="cpu", **HEADLINE)
    t_outs = [slam.process(u8[c * B:(c + 1) * B]) for c in range(N_CHUNKS)]
    tstep, _ = TS.build_slam_step(cfg.family, tcam, cfg.tag_size_inner, detector_params=tparams,
                                  device="cpu", **HEADLINE)
    return SimpleNamespace(cfg=cfg, traj=traj, u8=u8, j_outs=j_outs, j_states=j_states,
                           t_outs=t_outs, tstep=tstep, slam=slam)


def compare_outputs(got, want):
    for k in OUT_INTS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_allclose(got.poses.numpy(), want.poses, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(got.reproj_rms.numpy(), want.reproj_rms, atol=1e-3)
    np.testing.assert_allclose(got.pose_obs.numpy(), want.pose_obs, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.avg_node_distance.numpy(), want.avg_node_distance, rtol=1e-4)
    ok = np.asarray(want.det_ok)
    np.testing.assert_allclose(got.det_corners.numpy()[ok], want.det_corners[ok], atol=0.1)


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_step_chunk_parity(run, chunk):
    """The port's own run from the initial state, chunk by chunk."""
    compare_outputs(run.t_outs[chunk], run.j_outs[chunk])
    assert int(run.slam.ba_state.kf_ptr) == int(run.j_states[-1][1]["kf_ptr"])


def test_step_from_carried_state(run):
    """Chunk 2 from the reference's state after chunk 1, carried across."""
    graph, ba = run.j_states[0]
    state = state_from_jax_numpy(graph, ba, device="cpu")
    state, out = run.tstep(state, torch.as_tensor(run.u8[B:2 * B]))
    compare_outputs(out, run.j_outs[1])
    want_graph, want_ba = run.j_states[1]
    assert_state_close(state[0], want_graph, atol=2e-3)
    for k in ("kf_active", "kf_ptr", "lm_active", "obs_kf", "obs_lm", "obs_ok", "obs_ptr",
              "anchor", "frame_count"):
        np.testing.assert_array_equal(getattr(state[1], k).numpy(), want_ba[k], err_msg=k)


def _bench_ate_eval():
    """``bench._ate_eval`` itself, read from bench.py without running the
    module (importing it starts the bench)."""
    src = (ROOT / "bench.py").read_text()
    fn = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "_ate_eval")
    ns = {"np": np, "os": __import__("os")}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "bench.py", "exec"), ns)
    return ns["_ate_eval"]


def test_ate_eval_matches_bench(run):
    with jax.enable_x64(False):
        want = _bench_ate_eval()(run.cfg, jnp.asarray(run.traj.positions),
                                 jnp.asarray(run.traj.rotations), run.j_outs)
    got = ate_eval(TSceneConfig.from_file(), run.traj.positions, run.traj.rotations, run.t_outs)
    assert got[2] == want[2] and got[1] == want[1]
    assert got[0] == pytest.approx(want[0], abs=2e-3)
    assert got[0] < 1.0
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert got[3]["confident_frac"] == want[3]["confident_frac"]
        assert got[3]["ate_confident"] == pytest.approx(want[3]["ate_confident"], abs=2e-3)
