"""The port's loop-closure cost probes (``tools/probe_pgo_cost_torch.py``,
``probe_pgo_iters_torch.py``) and quads sub-stage probes
(``tools/probe_quads_torch.py``, ``probe_quads_batch_torch.py``) on the CPU
against the JAX probes' own functions and arithmetic on the same inputs.

The pose-graph probes run on a short out-and-back of the config-2 scene
(``randomize_scene(raw, 0.1, seed=7)``), rendered by the JAX package at
512x512, in chunks of 8 with ``pgo_loop_gap=4`` so that loop edges close
(as ``tests/test_torch_pipeline_options.py``'s pgo cases). At 384x384 this
path's ATE is 3.8 su and the chunk BA's map lands 0.038 units apart in the
two packages (float32 LM stopping short on a poorly conditioned map); at
512x512 the ATE is 0.46-0.50 su and the poses hold that file's tolerance.
The port's step is given the detections the JAX step made, as in that
file, so that a PnP branch tie cannot swap a loop edge between the two.
The JAX probes' stubs are set on ``aprilslam_tpu.slam.pipeline`` by the
test's monkeypatch. The quads probes run on the JAX detector's maps of
JAX-rendered frames at 384x384."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aprilslam_tpu.slam.pipeline as jpipe
from aprilslam_tpu.detect import DetectorParams as JDetectorParams
from aprilslam_tpu.detect import quads as JQ
from aprilslam_tpu.detect.segment import connected_components_auto as j_connected_components
from aprilslam_tpu.detect.threshold import adaptive_threshold_with_levels as j_threshold
from aprilslam_tpu.detect.threshold import decimate as j_decimate
from aprilslam_tpu.detect.threshold import to_grayscale as j_to_grayscale
from aprilslam_tpu.geometry import PinholeCamera as JCamera
from aprilslam_tpu.sim import SceneConfig as JSceneConfig
from aprilslam_tpu.sim import camera_in_tag_frames as j_camera_in_tag_frames
from aprilslam_tpu.sim import randomize_scene as j_randomize_scene
from aprilslam_tpu.sim import render_frames as j_render_frames
from aprilslam_tpu.sim import scene_tensors as j_scene_tensors
from aprilslam_tpu.sim import trajectory as j_trajectory
from aprilslam_tpu.slam import build_slam_step as j_build_slam_step
from aprilslam_tpu.slam.loop import pgo_init as j_pgo_init
from aprilslam_tpu.slam.taggraph import taggraph_init as j_taggraph_init
from aprilslam_tpu_torch import detect as TD
from aprilslam_tpu_torch.geometry import PinholeCamera
from aprilslam_tpu_torch.sim import DEFAULT_SCENE, SceneConfig, randomize_scene
from aprilslam_tpu_torch.sim import trajectory as t_trajectory
from aprilslam_tpu_torch.slam import pipeline as tpipe
from aprilslam_tpu_torch.slam.loop import pgo_init
from aprilslam_tpu_torch.slam.taggraph import taggraph_init

ROOT = Path(__file__).resolve().parents[1]
PGO_RES, B, FRAMES, LOOP_GAP = 512, 8, 24, 4
# Out and back along the tag row: the tags first seen drop out of view for
# more than LOOP_GAP frames and are re-observed on the way back.
OUT_AND_BACK = np.array([[0.0, 0.0, 10.0], [60.0, 0.0, 10.0], [0.0, 0.0, 10.0]])
PARAMS = dict(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
# Poses, port against JAX on the same detections: the chunk-schedule pgo
# tolerance of tests/test_torch_pipeline_options.py (units; measured at
# most 0.0052 apart on no_chunk_end, a uniform offset of a chunk's frames:
# the chunk BA's map).
POSE_ATOL = 1e-2
# The iters probe's ATE arithmetic (the port's ate_of) against the JAX
# probe's ate_of on the JAX step's outputs (su; measured 3.0e-8 apart: float32 ground truth on each side).
ATE_TOL = 1e-3
# The iters probe's row on the port against the JAX step's row, relative
# (measured 1.2 %: the port 0.50339 su, JAX 0.49753, on the same detections).
ATE_RUN_REL = 0.02
QUADS_RES, QUADS_FRAMES = 384, 8
# Quads, the full prefix: the reference's unstable cluster sort leaves the
# order inside a cluster open, so the stride subsample takes other points
# and the fit of a small cluster moves by pixels (ROADMAP.md, section 3).
# On clusters of at least BIG_CLUSTER boundary points (the tags here) the
# valid flags are equal and the corners, up to the cyclic start (a corner
# near +-pi can open the descending-angle order), within CORNER_TOL_PX
# (measured at most 0.043 px, on 9 such quads).
BIG_CLUSTER = 100
CORNER_TOL_PX = 0.1


def _load(name):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the JAX probes' stubs and ATE (tools/probe_pgo_cost.py:66-78, probe_pgo_iters.py:77-85)

def j_stub_tgsolve(tg, lm_pose, lm_active, anchor, hold=None, **kw):
    return lm_pose, jnp.asarray(False)


def j_stub_tgacc(tg, ids, T_obs, reliable, **kw):
    return tg


def j_stub_pgosolve(pgo, opt_iters=10):
    P = pgo.n_nodes_capacity
    eye = jnp.broadcast_to(jnp.eye(4, dtype=pgo.node_pose.dtype), (P, 4, 4))
    return pgo, eye, jnp.asarray(False)


J_NO_CHUNK_END = {"taggraph_solve": j_stub_tgsolve, "taggraph_accumulate": j_stub_tgacc,
                  "pgo_solve": j_stub_pgosolve}


def j_ate_of(jcfg, pos, rot, all_outs):
    ids = jcfg.tag_ids()
    gt_all = np.asarray(j_camera_in_tag_frames(
        jnp.asarray(jcfg.tag_positions()), jnp.asarray(jcfg.tag_rotations()), pos, rot))
    id_to_idx = {int(t): i for i, t in enumerate(ids)}
    est = np.concatenate([np.asarray(o.poses) for o in all_outs])
    valid = np.concatenate([np.asarray(o.valid) for o in all_outs])
    coord = np.concatenate([np.asarray(o.coord_id) for o in all_outs])
    t_idx = np.array([id_to_idx.get(int(c), -1) for c in coord])
    valid = valid & (t_idx >= 0)
    gt = gt_all[np.arange(len(est)), np.clip(t_idx, 0, len(ids) - 1)]
    errs = np.linalg.norm(est[valid, :3, 3] - gt[valid, :3, 3], axis=-1)
    return float(np.sqrt(np.mean(errs ** 2)))


@pytest.fixture(scope="module")
def scene():
    """The config-2 scene (both packages' configs), the camera, the
    out-and-back's poses and its frames rendered by the JAX package."""
    with open(DEFAULT_SCENE) as f:
        raw = json.load(f)
    jcfg = JSceneConfig.from_dict(j_randomize_scene(raw, 0.1, seed=7))
    traj = j_trajectory.scripted_waypoints(FRAMES, OUT_AND_BACK)
    with jax.enable_x64(False):
        jcam = JCamera.from_fov(PGO_RES, PGO_RES, jcfg.fov_y)
        pos, rot = jnp.asarray(traj.positions), jnp.asarray(traj.rotations)
        u8 = np.concatenate([np.asarray(jnp.clip(j_render_frames(
            j_scene_tensors(jcfg), pos[i:i + B], rot[i:i + B], jnp.asarray(jcam.inv_matrix), PGO_RES, PGO_RES,
            2) * 255.0, 0, 255).astype(jnp.uint8)) for i in range(0, FRAMES, B)])
    cfg = SceneConfig.from_dict(randomize_scene(raw, 0.1, seed=7))
    return dict(jcfg=jcfg, jcam=jcam, cfg=cfg, cam=PinholeCamera.from_fov(PGO_RES, PGO_RES, cfg.fov_y), u8=u8,
                traj=t_trajectory.Trajectory(np.asarray(traj.positions, np.float32),
                                             np.asarray(traj.rotations, np.float32)))


def j_run(scene, monkeypatch, patches, **kw):
    """The JAX probe's row: its step with ``patches`` on the JAX pipeline,
    one pass over the chunks from a fresh state (float32)."""
    with monkeypatch.context() as mp, jax.enable_x64(False):
        for k, v in patches.items():
            mp.setattr(jpipe, k, v)
        step, init = j_build_slam_step(
            scene["jcfg"].family, scene["jcam"], scene["jcfg"].tag_size_inner,
            detector_params=JDetectorParams(**PARAMS), estimator="ba", ba_schedule="chunk", init_joint_iters=3,
            ba_chunk_iters=4, pnp_iters=3, pgo=True, pgo_loop_gap=LOOP_GAP, **kw)
        step, state, outs = jax.jit(step), init(), []
        for i in range(0, FRAMES, B):
            state, o = step(state, jnp.asarray(scene["u8"][i:i + B]))
            outs.append(jax.device_get(o))
    return outs


@pytest.fixture(scope="module")
def j_rows(scene):
    """The JAX step's rows: ``no_chunk_end`` with the JAX probe's stubs and
    the iters probe's (4, 3) row at graph capacity 16."""
    mp = pytest.MonkeyPatch()
    try:
        return {"no_chunk_end": j_run(scene, mp, J_NO_CHUNK_END),
                "on_oi4_ti3": j_run(scene, mp, {}, graph_capacity=16, pgo_opt_iters=4, taggraph_iters=3)}
    finally:
        mp.undo()


@pytest.fixture()
def replay(scene, j_rows, monkeypatch):
    """The port's step given the JAX step's detections (by chunk); returns
    the chunks as the probes take them."""
    by_chunk = {}
    for c, o in enumerate(j_rows["no_chunk_end"]):
        ids = torch.as_tensor(np.asarray(o.det_ids))
        by_chunk[scene["u8"][c * B:(c + 1) * B].tobytes()] = TD.Detections(
            ids=ids, corners=torch.as_tensor(np.asarray(o.det_corners)), valid=ids >= 0,
            hamming=torch.zeros_like(ids), margin=torch.zeros(ids.shape), homography=torch.zeros(ids.shape + (3, 3)))
    monkeypatch.setattr(tpipe, "detect_fn", lambda *a, **k: (lambda frames: by_chunk[frames.numpy().tobytes()]))
    return [torch.from_numpy(scene["u8"][i:i + B].copy()) for i in range(0, FRAMES, B)]


def _port_row(scene, chunks, name, patches, **kw):
    pc = _load("probe_pgo_cost_torch")
    return pc.run_variant(scene["cfg"], scene["cam"], chunks, TD.DetectorParams(**PARAMS), "cpu", True, patches,
                          reps=0, pgo_loop_gap=LOOP_GAP, **kw)


def test_no_chunk_end_matches_jax_probe(scene, j_rows, replay):
    """Both taggraph functions and pgo_solve stubbed: the port's probe and
    the JAX probe's stubs on its step give the same valid mask, coordinate
    ids and loop edges, poses within POSE_ATOL; loop edges do close."""
    pc = _load("probe_pgo_cost_torch")
    got = _port_row(scene, replay, "no_chunk_end", pc.VARIANTS["no_chunk_end"][1])
    for o, j in zip(got["outputs"], j_rows["no_chunk_end"]):
        for k in ("valid", "coord_id", "loop_closures", "n_nodes"):
            np.testing.assert_array_equal(getattr(o, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)
        np.testing.assert_allclose(o.poses.numpy(), np.asarray(j.poses), atol=POSE_ATOL, rtol=2e-4)
    assert got["loops"] == int(np.asarray(j_rows["no_chunk_end"][-1].loop_closures)[-1]) >= 1
    assert got["fps"] is None and got["s"] is None
    # The stubs were restored.
    assert all(getattr(tpipe, k) is v for k, v in pc.ORIG.items())


def test_stubs_return_what_the_jax_stubs_return():
    pc = _load("probe_pgo_cost_torch")
    with jax.enable_x64(False):
        jp, jt = j_pgo_init(64, 192, 16, 16), j_taggraph_init(16)
        rng = np.random.default_rng(0)
        lm = rng.standard_normal((16, 4, 4)).astype(np.float32)
        jl, jmoved = j_stub_tgsolve(jt, jnp.asarray(lm), jnp.ones(16, bool), jnp.int32(0))
        _, jeye, jclosed = j_stub_pgosolve(jp)
    tp, tt = pgo_init(64, 192, 16, 16, device="cpu"), taggraph_init(16, device="cpu")
    tl, tmoved = pc.stub_tgsolve(tt, torch.as_tensor(lm), torch.ones(16, dtype=torch.bool), torch.tensor(0))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tmoved.dtype == torch.bool and tmoved.shape == () and bool(tmoved) == bool(jmoved) is False
    assert pc.stub_tgacc(tt, None, None, None) is tt and j_stub_tgacc(jt, None, None, None) is jt
    tp_out, teye, tclosed = pc.stub_pgosolve(tp)
    assert tp_out is tp
    np.testing.assert_array_equal(teye.numpy(), np.asarray(jeye))
    assert teye.dtype == tp.node_pose.dtype and bool(tclosed) == bool(jclosed) is False


def test_ate_rows_run_one_step_and_iters_ate_matches_jax(scene, j_rows, replay):
    """The ATE rows' ``partial(iters=...)`` is a no-op (the pipeline's call
    keyword wins), so ``on_cap16_it6`` and ``on_cap16_it4`` give equal
    outputs, equal to the iters probe's (4, 3) row, the chunk schedule's
    default depths. That row's ATE equals the JAX ate_of on the JAX step's
    outputs within ATE_TOL, with the same loop edges."""
    pc, pi = _load("probe_pgo_cost_torch"), _load("probe_pgo_iters_torch")
    rows = {name: _port_row(scene, replay, name, pc.iters_patch(it), graph_capacity=cap, count_ops=True)
            for name, cap, it, pgo in pc.ATE_ROWS if pgo}
    assert pc.same_outputs(rows["on_cap16_it6"]["outputs"], rows["on_cap16_it4"]["outputs"])
    # One step, so one count of dispatched operations.
    assert rows["on_cap16_it6"]["ops_per_frame"] == rows["on_cap16_it4"]["ops_per_frame"] > 0
    row = pi.iters_row(scene["cfg"], scene["cam"], scene["traj"], replay, TD.DetectorParams(**PARAMS), "cpu", True,
                       4, 3, reps=0, pgo_loop_gap=LOOP_GAP)
    assert pc.same_outputs(row["outputs"], rows["on_cap16_it6"]["outputs"])
    jo = j_rows["on_oi4_ti3"]
    pos, rot = scene["traj"].positions, scene["traj"].rotations
    with jax.enable_x64(False):
        j_ate = j_ate_of(scene["jcfg"], jnp.asarray(pos), jnp.asarray(rot), jo)
    # The probe's ATE arithmetic is the JAX probe's: on the JAX step's outputs.
    as_port = [SimpleNamespace(**{k: torch.as_tensor(np.asarray(getattr(o, k))) for k in ("poses", "valid",
                                                                                         "coord_id")}) for o in jo]
    assert pc.ate_of(scene["cfg"], scene["traj"], as_port) == pytest.approx(j_ate, abs=ATE_TOL)
    # The port's row against the JAX step's: the same loop edges and valid
    # frames, the ATE within ATE_RUN_REL.
    assert row["loops"] == int(np.asarray(jo[-1].loop_closures)[-1]) >= 1
    for o, j in zip(row["outputs"], jo):
        np.testing.assert_array_equal(o.valid.numpy(), np.asarray(j.valid))
    assert row["ate"] == pytest.approx(j_ate, rel=ATE_RUN_REL), (row["ate"], j_ate)


def test_op_count_and_interleaved_rounds():
    """``OpCount`` counts the operations a pass dispatches, and
    ``interleave`` times each row's pass in turn and moves its state on."""
    pc = _load("probe_pgo_cost_torch")
    chunks = [torch.ones(2, 3), torch.ones(2, 3)]

    def row(k):
        return {"device": torch.device("cpu"), "patches": {}, "state": torch.zeros(()),
                "step": lambda state, c: (state + k * c.sum(), None)}

    rows = {"a": row(1.0), "b": row(2.0)}
    with pc.OpCount() as counter:
        pc.one_pass(rows["a"], chunks)
    assert counter.n == 2 * 3  # per chunk: sum, mul, add
    got = pc.interleave(rows, chunks, 2)
    assert set(got) == {"a", "b"} and all(r["fps_best"] >= r["fps_median"] > 0 for r in got.values())
    assert float(rows["a"]["state"]) == 3 * 12.0 and float(rows["b"]["state"]) == 2 * 24.0
    assert pc.removes({"off": 100.0, "on": 200.0, "no_chunk_end": 150.0}) == {"no_chunk_end": 50.0}


# ---- quads ---------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quads_maps():
    """JAX-rendered monte_carlo(8, seed=3) of the default scene at 384x384
    (float, as the JAX probes feed them) and the JAX detector's maps of
    them, as numpy; the XLA labelling converges on them (asserted against
    the port's CCL)."""
    p = JDetectorParams(**PARAMS)
    with jax.enable_x64(False):
        cfg = JSceneConfig.from_file()
        cam = JCamera.from_fov(QUADS_RES, QUADS_RES, cfg.fov_y)
        traj = j_trajectory.monte_carlo(QUADS_FRAMES, seed=3)
        frames = j_render_frames(j_scene_tensors(cfg), jnp.asarray(traj.positions), jnp.asarray(traj.rotations),
                                 jnp.asarray(cam.inv_matrix), QUADS_RES, QUADS_RES, 2)
        dec = j_decimate(j_to_grayscale(frames), p.quad_decimate)
        trin, level = j_threshold(dec, tile=p.tile, min_contrast=p.min_contrast)
        labels = j_connected_components(trin, p.scan_iters, p.jump_iters)
        m = jax.device_get((trin, labels, dec, level))
    np.testing.assert_array_equal(TD.connected_components(torch.as_tensor(np.array(m[0]))).numpy(), m[1])
    return m


def j_prefixes(p):
    """tools/probe_quads_batch.py:62-80, the JAX prefixes (its full prefix
    returns the corners; here the whole candidates, to hold the mask too)."""
    def emit(t, lab, g, lv):
        return JQ._emit_boundaries(t, lab, g, lv)

    def emit_compact(t, lab, g, lv):
        return jax.vmap(lambda *a: JQ._compact(*a, p.max_boundary))(*emit(t, lab, g, lv))

    def emit_compact_cluster(t, lab, g, lv):
        return jax.vmap(lambda *a: JQ._cluster(*a, p.max_clusters, p.min_cluster_pts))(*emit_compact(t, lab, g, lv))

    def full(t, lab, g, lv):
        return JQ.quad_candidates(
            t, lab, g, p.quad_decimate, lv, max_clusters=p.max_clusters, max_quads=p.max_quads,
            pts_per_quad=p.pts_per_quad, min_cluster_pts=p.min_cluster_pts, min_side=p.min_side,
            refine_iters=p.refine_iters, max_fit_err=p.max_fit_err, max_boundary=p.max_boundary)

    return {"emit": emit, "emit+compact": emit_compact, "+cluster": emit_compact_cluster, "full quads": full}


def test_quads_prefixes_match_jax(quads_maps):
    """Each prefix of the batch probe against the JAX probe's on the same
    maps: boundary keys and payload exact, compacted keys exact, the
    order-free cluster statistics exact (as tests/test_torch_detect.py
    holds them), the full prefix's corners within CORNER_TOL_PX with the
    same valid quads."""
    qb = _load("probe_quads_batch_torch")
    jp = JDetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16)
    with jax.enable_x64(False):
        want = {k: jax.device_get(jax.jit(f)(*quads_maps)) for k, f in j_prefixes(jp).items()}
    args = [torch.as_tensor(np.array(a)) for a in quads_maps]
    got = {k: f(*args) for k, f in qb.prefixes().items()}
    for g, w in zip(got["emit"], want["emit"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    g, w = got["emit+compact"], want["emit+compact"]
    live = np.asarray(w[0]) < int(JQ._BIG)
    for k in range(5):
        if k < 2 or k == 4:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=str(k))
        else:
            np.testing.assert_array_equal(g[k].numpy()[live], np.asarray(w[k])[live], err_msg=str(k))
    for k, v in want["+cluster"][1].items():
        np.testing.assert_array_equal(got["+cluster"][1][k].numpy(), np.asarray(v), err_msg=k)
    # The batch probe's full prefix returns the corners of quad_candidates.
    q = TD.quad_candidates(*args[:3], 2, args[3], **_load("probe_quads_torch").quads_kwargs(qb.PARAMS))
    assert torch.equal(torch.nan_to_num(got["full quads"]), torch.nan_to_num(q.corners))
    jq = want["full quads"]
    np.testing.assert_array_equal(q.cluster_size.numpy(), np.asarray(jq.cluster_size))
    big = q.cluster_size.numpy() >= BIG_CLUSTER
    np.testing.assert_array_equal(q.valid.numpy()[big], np.asarray(jq.valid)[big])
    v = big & np.asarray(jq.valid)
    assert v.sum() >= 6
    tc, jc = q.corners.numpy()[v], np.asarray(jq.corners)[v]
    gap = np.min([np.abs(np.roll(tc, s, axis=-2) - jc).max(axis=(-1, -2)) for s in range(4)], axis=0)
    assert gap.max() <= CORNER_TOL_PX, gap


def test_quads_batch_run_first_frames_equal_smaller_batch():
    """The batch probe's run at B = 8 and 16 on the CPU: frames 0-7 of the
    batch of 16 are the batch of 8's, and so is every prefix's output on
    them; every row has its wall time and no kernel time off the card."""
    qb = _load("probe_quads_batch_torch")
    r = qb.run("cpu", QUADS_RES, 1, batches=(8, 16))
    small, big = r[8], r[16]
    assert torch.equal(big["maps"]["frames"][:8], small["maps"]["frames"])
    for name in qb.prefixes():
        leaves = jax.tree_util.tree_leaves
        for a, b in zip(leaves(big["outputs"][name]), leaves(small["outputs"][name]), strict=True):
            assert torch.equal(torch.nan_to_num(a[:8]), torch.nan_to_num(b)), name
        for B, row in ((8, small["rows"][name]), (16, big["rows"][name])):
            assert row["ms"] > 0 and row["ms_per_frame"] == row["ms"] / B and row["kernel_ms"] is None


def test_quads_probe_rows_and_sort():
    """probe_quads_torch's run on the CPU: every JAX row, wall ms, no
    kernel ms off the card; its key sort orders the keys ``_cluster``
    sorts (non-decreasing, a permutation of them)."""
    pq = _load("probe_quads_torch")
    r = pq.run("cpu", 2, 256, reps=1)
    assert list(r["rows"]) == ["dispatch floor (noop)", "emit_boundaries", "compact", "cluster (sort+segstats)",
                               "  sort alone", "quad_candidates (full)"]
    assert all(row["ms"] > 0 and row["kernel_ms"] is None for row in r["rows"].values())
    m = pq.maps(2, 256, "cpu")
    comp = TD.quads._compact(*TD.quads._emit_boundaries(m["trinary"], m["labels"], m["dec"], m["level"]),
                             pq.PARAMS.max_boundary)
    keys, _ = pq.sort_keys(comp[0], comp[1])
    raw = comp[0].to(torch.int64) * 2**31 + comp[1].to(torch.int64)
    assert torch.equal(keys, torch.sort(raw, dim=1).values)
