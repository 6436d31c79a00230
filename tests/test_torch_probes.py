"""The port's diagnostic probes (``tools/probe_*_torch.py``) on the CPU: the
robustness sweep's floor verdict, the detector stages' fate of every
expected tag against the JAX detector's stages on the same frames, and the
ATE analyses of the headline step: the ATE distribution against the same
arithmetic on the JAX step's outputs for one JAX-rendered pool, and the
tail split's re-localizations and negev's IPPE branches against the JAX
probes' own arithmetic on the JAX step's outputs and final map."""

import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu import sim as jsim
from aprilslam_tpu.detect import DetectorParams as JDetectorParams
from aprilslam_tpu.detect.decode import FamilyTensors as JFamilyTensors
from aprilslam_tpu.detect.decode import decode_quads as j_decode_quads
from aprilslam_tpu.detect.quads import quad_candidates as j_quad_candidates
from aprilslam_tpu.detect.segment import connected_components_auto as j_connected_components
from aprilslam_tpu.detect.threshold import adaptive_threshold_with_levels as j_threshold
from aprilslam_tpu.detect.threshold import decimate as j_decimate
from aprilslam_tpu.detect.threshold import to_grayscale as j_to_grayscale
from aprilslam_tpu.families import get_family as j_get_family
from aprilslam_tpu.geometry import PinholeCamera as JCamera
from aprilslam_tpu.geometry import se3_inverse as j_se3_inverse
from aprilslam_tpu.pose.pnp import solve_planar_pnp_dual as j_solve_planar_pnp_dual
from aprilslam_tpu.slam import build_slam_step as j_build_slam_step
from aprilslam_tpu.slam.localize import joint_camera_pose as j_joint_camera_pose
from aprilslam_tpu.slam.localize import pose_observability as j_pose_observability
from aprilslam_tpu_torch.eval import ate_eval
from aprilslam_tpu_torch.sim import trajectory

ROOT = Path(__file__).resolve().parents[1]
# The headline pool of tests/test_torch_bench.py: JAX monte_carlo(16, seed=3)
# poses rendered by the JAX rasterizer at 384x384, as uint8; chunks of 8.
RES, FRAMES, BATCH = 384, 16, 8
# The port's ATE RMSE against the JAX step's on that pool, relative.
ATE_REL_TOL = 0.01
# The detector stages' fates, port against JAX on the same frames: the
# nearest valid quad's corner gap to the oracle (px; measured at most 0.049
# apart, on the noisy frames; the threshold shares and black components
# are equal).
STAGE_QUAD_TOL_PX = 0.1
# The tail split and negev, port against JAX on the same step outputs and
# map. Per-frame translation error after the Gauss-Newton, and every RMSE
# (su; measured at most 0.00021 apart).
TAIL_ERR_TOL = 1e-3
# sigma_min relative (measured at most 1.5 % apart where two or more tags
# are seen); on one-tag frames the smallest eigenvalue of J^T J lies below
# float32's resolution of it, so there it is held absolutely (measured: one
# side reads 0 where the other reads up to 0.0997).
TAIL_SMIN_REL = 0.02
ONE_TAG_SMIN_TOL = 0.15
# negev's branches: reprojection RMS (px; measured at most 4.9e-5 apart),
# and branch errors and the picks' RMSE relative (measured 0.16 % on the
# one-tag frame whose wrong branch sits 24.3 su off, and 0.05 % on the
# RMSE), beside TAIL_ERR_TOL.
NEGEV_RMS_TOL = 1e-3
NEGEV_ERR_REL = 5e-3


def _load(name):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _bench():
    """``bench_torch`` as the probes import it (they put the repo's root on
    the path)."""
    _load("probe_ate_dist_torch")
    import bench_torch

    where = getattr(bench_torch, "__file__", None)
    assert where is not None and Path(where).resolve() == ROOT / "bench_torch.py", (
        f"sys.modules['bench_torch'] is {bench_torch!r}, not the repo's bench_torch.py: an earlier test in "
        "this process left another module under that name")
    return bench_torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_robustness_run_gives_the_floor_verdicts():
    """``floor_ok`` on rows at the edge of each scenario's floor in FLOORS:
    the edge holds; one tag fewer than the floor's rate or count, an RMS
    above its limit, one false id, or fewer expected tags than its least
    each fails. The CLEAN control has no floor. (The sweep's own rows on the
    CPU are held to the floors by ``tests/test_torch_detect_robustness.py``'s
    own arm.)"""
    prt = _load("probe_robustness_torch")
    assert prt.floor_ok("clean", 0, 6, float("inf"), 3) is None
    for name, f in prt.FLOORS.items():
        expected = max(f.get("min_expected", 1), 10)
        found = max(int(np.ceil(f.get("min_rate", 0.0) * expected)), f.get("min_found", 0))
        rms = f.get("max_rms", 5.0)
        assert prt.floor_ok(name, found, expected, rms, 0) is True, name
        assert prt.floor_ok(name, found, expected, rms, 1) is False, name
        assert prt.floor_ok(name, found - 1, expected, rms, 0) is False, name
        if "max_rms" in f:
            assert prt.floor_ok(name, found, expected, rms + 0.01, 0) is False, name
        if "min_expected" in f:
            few = f["min_expected"] - 1
            assert prt.floor_ok(name, few, few, rms, 0) is False, name


def _j_stages(frames):
    """tools/probe_detect_stages.py's ``stages``: the JAX detector's stages
    one by one at ``quad_decimate=1`` (its CCL through the XLA labelling on
    the CPU)."""
    p = JDetectorParams(quad_decimate=1, min_cluster_pts=12)
    gray = j_to_grayscale(frames)
    dec = j_decimate(gray, p.quad_decimate)
    trinary, level = j_threshold(dec, tile=p.tile, min_contrast=p.min_contrast)
    labels = j_connected_components(trinary, p.scan_iters, p.jump_iters)
    quads = j_quad_candidates(
        trinary, labels, dec, p.quad_decimate, level, max_clusters=p.max_clusters, max_quads=p.max_quads,
        pts_per_quad=p.pts_per_quad, min_cluster_pts=p.min_cluster_pts, min_side=p.min_side,
        refine_iters=p.refine_iters, max_fit_err=p.max_fit_err, max_boundary=p.max_boundary)
    det = j_decode_quads(gray, quads, JFamilyTensors(j_get_family("tagStandard41h12")),
                         max_hamming=p.max_hamming, min_level_contrast=p.min_level_contrast,
                         max_detections=p.max_detections)
    return jax.device_get((gray, trinary, labels, quads, det))


def test_detect_stages_name_the_last_stage_reached():
    """The fate of every expected tag in the JAX tool's two runs (the clean
    frames and their noise at sigma 0.05 from ``PRNGKey(7)``, rendered and
    degraded by the JAX package) from the port's stages and from the JAX
    detector's stages on the same frames: the same tags, the same last
    stage (decode for all six, clean and noisy), the same threshold shares
    and largest black components, the nearest quads' corner gaps within
    STAGE_QUAD_TOL_PX. On frames of
    background only each tag dies at the threshold."""
    prt, pds = _load("probe_robustness_torch"), _load("probe_detect_stages_torch")
    with jax.enable_x64(False):
        cfg = jsim.SceneConfig.from_file()
        cam = JCamera.from_fov(prt.RES, prt.RES, cfg.fov_y)
        scene = jsim.scene_tensors(cfg)
        pos = jnp.asarray(prt.POSES, jnp.float32)
        rot = jnp.zeros((3, 3), jnp.float32)
        clean = jsim.render_frames(scene, pos, rot, jnp.asarray(cam.inv_matrix), prt.RES, prt.RES, 2)
        gt_uv, gt_valid = jsim.project_border_corners(scene, pos, rot, jnp.asarray(cam.matrix))
        unocc = jsim.tags_unoccluded(scene.tag_pos, scene.tag_rot, pos, scene.inner_size, scene.outer_half)
        runs = {"clean": clean, "noise0.05": jsim.degrade.gaussian_noise(clean, 0.05, jax.random.PRNGKey(7))}
        for name, x in runs.items():
            sc = prt.Scenario(name, torch.from_numpy(np.array(x, np.float32)), scene, np.asarray(gt_uv),
                              np.asarray(gt_valid & unocc), cfg.family)
            port, ref = pds.fates(sc), pds.fates(sc, _j_stages(x))
            assert [(f["frame"], f["tag"]) for f in port] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 2)]
            assert [f["last_stage"] for f in port] == [f["last_stage"] for f in ref] == ["decode"] * 6, (port, ref)
            for fp, fj in zip(port, ref):
                gap = fp.pop("quad_corner_gap") - fj.pop("quad_corner_gap")
                assert fp == fj and abs(gap) <= STAGE_QUAD_TOL_PX, (name, fp, fj, gap)
        blank = sc._replace(frames=torch.full_like(sc.frames, float(scene.background)))
    assert [f["last_stage"] for f in pds.fates(blank)] == ["none"] * 6


def test_ascii_dump_of_the_clean_miss_region():
    pa = _load("probe_ascii_torch")
    gray = np.linspace(0.0, 1.0, 512 * 512, dtype=np.float32).reshape(512, 512)
    trin = np.tile(np.array([-1, 0, 1], np.int8), 512 * 512 // 3 + 1)[:512 * 512].reshape(512, 512)
    lines = pa.ascii_dump(gray, trin)
    n = len(pa.ROWS)
    assert len(lines) == 2 * n + 1 and lines[n].startswith("===")
    assert all(len(line) == 4 + len(pa.COLS) for line in lines[:n] + lines[n + 1:])
    assert set("".join(line[4:] for line in lines[n + 1:])) == {".", "o", "#"}


@pytest.fixture(scope="module")
def pool():
    """The JAX-rendered pool and its poses, and the JAX headline step's
    outputs on it (chunks of 8, float32) and its final BA state."""
    pad = _load("probe_ate_dist_torch")
    with jax.enable_x64(False):
        cfg = jsim.SceneConfig.from_file()
        cam = JCamera.from_fov(RES, RES, cfg.fov_y)
        traj = jsim.trajectory.monte_carlo(FRAMES, seed=3)
        pos, rot = jnp.asarray(traj.positions), jnp.asarray(traj.rotations)
        u8 = np.concatenate([np.asarray(jnp.clip(jsim.render_frames(
            jsim.scene_tensors(cfg), pos[i:i + BATCH], rot[i:i + BATCH], jnp.asarray(cam.inv_matrix), RES, RES,
            2) * 255.0, 0, 255).astype(jnp.uint8)) for i in range(0, FRAMES, BATCH)])
        step, init = j_build_slam_step(
            cfg.family, cam, cfg.tag_size_inner,
            detector_params=JDetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16,
                                            max_boundary=8192),
            **_bench().Knobs.from_env(False, env={}).step_kwargs())
        step, state, jouts = jax.jit(step), init(), []
        for i in range(0, FRAMES, BATCH):
            state, o = step(state, u8[i:i + BATCH])
            jouts.append(jax.device_get(o))
    _graph, ba = state
    return u8, trajectory.Trajectory(np.array(traj.positions, np.float32),
                                     np.array(traj.rotations, np.float32)), pad.outputs_numpy(jouts), ba


@pytest.fixture(scope="module")
def port_run(pool):
    """The port's headline step (``headline_run``: ``bench_torch``'s detector
    and knobs) on the pool, on the CPU."""
    u8, traj, _jo, _ba = pool
    return _load("probe_ate_dist_torch").headline_run("cpu", FRAMES, RES, BATCH, frames=u8, traj=traj)


def test_ate_distribution_matches_jax_outputs(pool, port_run):
    """The ATE distribution of the port's step and of the JAX step on one
    pool: the same frames scored, the same split by visible tags, the RMSE
    within ATE_REL_TOL. Measured on the CPU: the port 1.22719 su, JAX
    1.22652 (0.05 %), 15 frames scored each, 3, 11 and 1 of them with 1, 2
    and 3 visible tags."""
    pad = _load("probe_ate_dist_torch")
    _u8, traj, jo, _ba = pool
    cfg, to = port_run["cfg"], port_run["outputs"]
    d_port, d_jax = pad.ate_distribution(cfg, traj, to), pad.ate_distribution(cfg, traj, jo)
    assert d_port["n"] == d_jax["n"] > 0
    assert {k: b["n"] for k, b in d_port["by_n_visible"].items()} == \
        {k: b["n"] for k, b in d_jax["by_n_visible"].items()}
    assert d_port["rmse"] == pytest.approx(d_jax["rmse"], rel=ATE_REL_TOL), (d_port["rmse"], d_jax["rmse"])
    # The same arithmetic as the port's ATE.
    assert d_port["rmse"] == pytest.approx(ate_eval(cfg, traj.positions, traj.rotations, port_run["chunks"])[0],
                                           rel=1e-6)
    assert d_port["max"] >= d_port["p90"] >= d_port["median"] > 0
    assert len(d_port["worst"]) == 10 and d_port["worst"][0][1] == pytest.approx(d_port["max"])


def test_tail_split_and_negev_on_the_port_step(pool, port_run):
    """Both analyses run on the step's outputs and final map: the reported
    RMSE is the ATE distribution's, the true map puts the first tag at the
    origin, and every count covers the scored frames."""
    pad, pts, pn = _load("probe_ate_dist_torch"), _load("probe_tail_split_torch"), _load("probe_negev_torch")
    _u8, traj, _jo, _ba = pool
    cfg, cam, to, ba = port_run["cfg"], port_run["cam"], port_run["outputs"], port_run["ba_state"]
    dist = pad.ate_distribution(cfg, traj, to)
    rmse, n = dist["rmse"], dist["n"]

    world, held = pts.true_map(cfg, traj, ba.n_landmarks, "cpu")
    first = int(cfg.tag_ids()[0])
    assert bool(held[first]) and torch.allclose(world[first], torch.eye(4), atol=1e-5)
    assert int(held.sum()) == len(cfg.tag_ids())

    ts = pts.tail_split(cfg, cam, traj, to, ba)
    assert ts["reported_rmse"] == pytest.approx(rmse, rel=1e-9)
    assert np.isfinite(ts["est_map_rmse"]) and np.isfinite(ts["gt_map_rmse"])
    assert sum(b["n"] for b in ts["by_n_visible"].values()) == n
    assert [g[1] for g in ts["gating"]][0] == n
    assert all(a >= b for a, b in zip([g[1] for g in ts["gating"]], [g[1] for g in ts["gating"]][1:]))

    ng = pn.negev(cfg, cam, traj, to, ba)
    assert ng["reported_rmse"] == pytest.approx(rmse, rel=1e-9) and ng["scored"] == n
    assert np.isfinite(ng["rms_pick_rmse"]) and np.isfinite(ng["negev_pick_rmse"])
    assert 0 <= ng["right_branch_with_contradictions"] <= n
    assert all(r[-1] in (True, False) for r in ng["changed"])


def _j_scatter_frame(ids, ok, corners, M):
    """The JAX probes' ``scatter_frame``."""
    okm = ok & (ids >= 0) & (ids < M)
    slot = jnp.where(okm, jnp.clip(ids, 0, M - 1), M)
    corn_m = jnp.zeros((M, 4, 2), dtype=corners.dtype).at[slot].set(corners, mode="drop")
    seen = jnp.zeros((M,), bool).at[slot].set(True, mode="drop")
    return corn_m, seen


def _j_truth(cfg, traj, jo):
    """The JAX probes' ground truth: each frame's true camera pose in its
    coordinate tag's frame, and the frames scored (valid, in a scene tag's
    frame)."""
    gt_all = np.asarray(jsim.camera_in_tag_frames(
        jnp.asarray(cfg.tag_positions()), jnp.asarray(cfg.tag_rotations()), jnp.asarray(traj.positions),
        jnp.asarray(traj.rotations)))
    ids_gt = cfg.tag_ids()
    id_to_idx = {int(t): i for i, t in enumerate(ids_gt)}
    t_idx = np.array([id_to_idx.get(int(c), -1) for c in jo["coord_id"]])
    gt = gt_all[np.arange(len(t_idx)), np.clip(t_idx, 0, len(ids_gt) - 1)]
    return gt, jo["valid"] & (t_idx >= 0)


def _j_frames(fn, jo, keys):
    """``fn`` jitted, frame by frame over ``jo``'s ``keys``, as the JAX probes
    loop; each output stacked over the frames."""
    fn = jax.jit(fn)
    outs = [jax.device_get(fn(*(jnp.asarray(jo[k][i]) for k in keys))) for i in range(len(jo["valid"]))]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0]))]


def _j_tail_split(traj, jo, ba):
    """tools/probe_tail_split.py's arithmetic on the JAX step's outputs and
    final BA state: its true map (:95-108), its ``eval_frame`` (:125-145)
    frame by frame, its errors and RMSEs (:148-170). Per frame: the errors
    and sigma_min against the estimated map (``err_e``, ``smin_e``) and
    the true map (``err_g``, ``smin_g``); the frames scored ``v``."""
    with jax.enable_x64(False):
        cfg = jsim.SceneConfig.from_file()
        K = jnp.asarray(JCamera.from_fov(RES, RES, cfg.fov_y).matrix)
        tag_size, ids_gt = cfg.tag_size_inner, cfg.tag_ids()
        lm_pose, lm_active, Ml = ba.lm_pose, ba.lm_active, int(ba.n_landmarks)
        c = np.asarray(jsim.camera_in_tag_frames(
            jnp.asarray(cfg.tag_positions()), jnp.asarray(cfg.tag_rotations()), jnp.asarray(traj.positions[:1]),
            jnp.asarray(traj.rotations[:1])))[0]
        T_rel = np.einsum("ij,tjk->tik", c[0], np.linalg.inv(c))
        gt_map, gt_ok = np.tile(np.eye(4, dtype=np.float32), (Ml, 1, 1)), np.zeros(Ml, bool)
        for i, t in enumerate(ids_gt):
            if int(t) < Ml:
                gt_map[int(t)], gt_ok[int(t)] = T_rel[i], True
        gt_map, gt_ok = jnp.asarray(gt_map), jnp.asarray(gt_ok)

        def eval_frame(ids_b, ok_b, corners_b, pose_b, coord_b):
            corn_m, seen = _j_scatter_frame(ids_b, ok_b, corners_b, Ml)
            c_slot = jnp.clip(coord_b, 0, Ml - 1)
            use_e, T_wa = seen & lm_active, lm_pose[c_slot]
            T_e, _r = j_joint_camera_pose(lm_pose, use_e, corn_m, K, tag_size, T_wa @ pose_b, iters=8)
            smin_e = j_pose_observability(lm_pose, use_e, K, tag_size, T_e)
            use_g = seen & gt_ok
            T_g, _r = j_joint_camera_pose(gt_map, use_g, corn_m, K, tag_size, gt_map[c_slot] @ pose_b, iters=8)
            smin_g = j_pose_observability(gt_map, use_g, K, tag_size, T_g)
            return j_se3_inverse(T_wa) @ T_e, smin_e, j_se3_inverse(gt_map[c_slot]) @ T_g, smin_g

        T_e, smin_e, T_g, smin_g = _j_frames(eval_frame, jo, ("det_ids", "det_ok", "det_corners", "poses",
                                                              "coord_id"))
        gt, v = _j_truth(cfg, traj, jo)
    return {"err_e": np.linalg.norm(T_e[:, :3, 3] - gt[:, :3, 3], axis=-1), "smin_e": smin_e,
            "err_g": np.linalg.norm(T_g[:, :3, 3] - gt[:, :3, 3], axis=-1), "smin_g": smin_g, "gt": gt, "v": v}


def _j_negev(traj, jo, ba):
    """tools/probe_negev.py's arithmetic on the JAX step's outputs and final
    BA state: its ``contradiction`` (:95-118) and ``eval_frame`` (:121-140)
    frame by frame, the hypotheses in the coordinate tag's frame and their
    errors (:147-175). Per frame: ``r_a``, ``c_a``, ``e_a`` and the same of
    branch b, the true pose ``gt``; the frames scored ``v``."""
    with jax.enable_x64(False):
        cfg = jsim.SceneConfig.from_file()
        cam = JCamera.from_fov(RES, RES, cfg.fov_y)
        K, tag_size, W, H = jnp.asarray(cam.matrix), cfg.tag_size_inner, cam.width, cam.height
        lm_pose, lm_active, Ml = ba.lm_pose, ba.lm_active, int(ba.n_landmarks)

        def contradiction(T_wc, seen, min_side_px=22.0, margin=0.10, z_min=1.0, facing_min=0.35):
            T_cw = j_se3_inverse(T_wc)
            Xc = lm_pose[:, :3, 3] @ T_cw[:3, :3].T + T_cw[:3, 3]
            z = Xc[:, 2]
            f = K[0, 0]
            zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
            u = f * Xc[:, 0] / zs + K[0, 2]
            v = K[1, 1] * Xc[:, 1] / zs + K[1, 2]
            side = f * tag_size / jnp.maximum(zs, 1e-6)
            mx, my = margin * W, margin * H
            inside = (u > mx) & (u < W - mx) & (v > my) & (v < H - my)
            n_c = lm_pose[:, :3, 2] @ T_cw[:3, :3].T
            ray = Xc / jnp.maximum(jnp.linalg.norm(Xc, axis=-1, keepdims=True), 1e-9)
            facing = jnp.abs(jnp.sum(n_c * ray, axis=-1))
            return jnp.sum(lm_active & (z > z_min) & inside & (side > min_side_px) & (facing > facing_min) & ~seen)

        def eval_frame(ids_b, ok_b, corners_b):
            res = j_solve_planar_pnp_dual(corners_b, K, tag_size, iters=3)
            corn_m, seen = _j_scatter_frame(ids_b, ok_b, corners_b, Ml)
            use = seen & lm_active
            idsc = jnp.clip(ids_b, 0, Ml - 1)
            cand = ok_b & (ids_b >= 0) & (ids_b < Ml) & lm_active[idsc]
            c_idx = jnp.argmin(jnp.where(cand, ids_b, 2**30))
            T_lm = jnp.where(lm_active[idsc[c_idx]], lm_pose[idsc[c_idx]], jnp.eye(4, dtype=lm_pose.dtype))
            T_a, r_a = j_joint_camera_pose(lm_pose, use, corn_m, K, tag_size, T_lm @ j_se3_inverse(res.T[c_idx]),
                                           iters=6)
            T_b, r_b = j_joint_camera_pose(lm_pose, use, corn_m, K, tag_size,
                                           T_lm @ j_se3_inverse(res.T_alt[c_idx]), iters=6)
            return T_a, r_a, contradiction(T_a, seen), T_b, r_b, contradiction(T_b, seen)

        T_a, r_a, c_a, T_b, r_b, c_b = _j_frames(eval_frame, jo, ("det_ids", "det_ok", "det_corners"))
        gt, v = _j_truth(cfg, traj, jo)
    T_wco = np.asarray(lm_pose)[np.clip(jo["coord_id"], 0, Ml - 1)]
    A, Bb = np.linalg.inv(T_wco) @ T_a, np.linalg.inv(T_wco) @ T_b
    return {"r_a": r_a, "c_a": c_a, "e_a": np.linalg.norm(A[:, :3, 3] - gt[:, :3, 3], axis=-1),
            "r_b": r_b, "c_b": c_b, "e_b": np.linalg.norm(Bb[:, :3, 3] - gt[:, :3, 3], axis=-1), "gt": gt, "v": v}


def _rmse(e, m):
    return float(np.sqrt(np.mean(e[m] ** 2)))


def _torch_ba(ba):
    """The JAX step's final BA state as the probes read the port's."""
    return types.SimpleNamespace(lm_pose=torch.from_numpy(np.array(ba.lm_pose, np.float32)),
                                 lm_active=torch.from_numpy(np.array(ba.lm_active)), n_landmarks=int(ba.n_landmarks))


def test_tail_split_matches_jax_arithmetic(pool, port_run):
    """The port's tail split (``relocalize`` and ``summarize``) on the JAX
    step's outputs and final map against tools/probe_tail_split.py's own
    arithmetic on the same: every scored frame's error against both maps
    within TAIL_ERR_TOL su and its sigma_min within TAIL_SMIN_REL (one-tag
    frames: ONE_TAG_SMIN_TOL), the est-map and true-map RMSE and their split by visible tags within
    TAIL_ERR_TOL, the same frames in each split."""
    pts = _load("probe_tail_split_torch")
    _u8, traj, jo, ba = pool
    cfg, cam = port_run["cfg"], port_run["cam"]
    j = _j_tail_split(traj, jo, ba)
    f = pts.relocalize(cfg, cam, traj, jo, _torch_ba(ba))
    v, gt, nvis = j["v"], j["gt"], jo["n_visible"]
    err_e = np.linalg.norm(f["T_e"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    err_g = np.linalg.norm(f["T_g"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    np.testing.assert_allclose(err_e[v], j["err_e"][v], rtol=0, atol=TAIL_ERR_TOL)
    np.testing.assert_allclose(err_g[v], j["err_g"][v], rtol=0, atol=TAIL_ERR_TOL)
    one = v & (nvis == 1)
    for k in ("smin_e", "smin_g"):
        np.testing.assert_allclose(f[k][v & ~one], j[k][v & ~one], rtol=TAIL_SMIN_REL, err_msg=k)
        np.testing.assert_allclose(f[k][one], j[k][one], rtol=0, atol=ONE_TAG_SMIN_TOL, err_msg=k)

    d = pts.summarize(cfg, traj, jo, f)
    assert d["est_map_rmse"] == pytest.approx(_rmse(j["err_e"], v), abs=TAIL_ERR_TOL)
    assert d["gt_map_rmse"] == pytest.approx(_rmse(j["err_g"], v), abs=TAIL_ERR_TOL)
    split = {str(k): v & (nvis == k) for k in range(1, 6) if (v & (nvis == k)).any()}
    assert list(d["by_n_visible"]) == list(split)
    for k, m in split.items():
        b = d["by_n_visible"][k]
        assert b["n"] == int(m.sum())
        assert b["est"] == pytest.approx(_rmse(j["err_e"], m), abs=TAIL_ERR_TOL), (k, b)
        assert b["gt"] == pytest.approx(_rmse(j["err_g"], m), abs=TAIL_ERR_TOL), (k, b)


def test_negev_matches_jax_arithmetic(pool, port_run):
    """The port's negev (``branches`` and ``summarize``) on the JAX step's
    outputs and final map against tools/probe_negev.py's own arithmetic on
    the same: every scored frame's contradiction counts equal, its branch
    RMS within NEGEV_RMS_TOL px and its branch errors within NEGEV_ERR_REL
    (and TAIL_ERR_TOL su); both picks' RMSE as close; the same frames where
    the picks differ, each as right or wrong (none on this pool); the same
    count of right branches with contradictions."""
    pn = _load("probe_negev_torch")
    _u8, traj, jo, ba = pool
    cfg, cam = port_run["cfg"], port_run["cam"]
    j = _j_negev(traj, jo, ba)
    br = pn.branches(cfg, cam, jo, _torch_ba(ba))
    d = pn.summarize(cfg, traj, jo, br)
    v, gt = j["v"], j["gt"]
    np.testing.assert_array_equal(br["c_a"][v], j["c_a"][v])
    np.testing.assert_array_equal(br["c_b"][v], j["c_b"][v])
    for b in ("a", "b"):
        np.testing.assert_allclose(br[f"r_{b}"][v], j[f"r_{b}"][v], rtol=0, atol=NEGEV_RMS_TOL)
        e = np.linalg.norm(br[f"T_{b}"][:, :3, 3] - gt[:, :3, 3], axis=-1)
        np.testing.assert_allclose(e[v], j[f"e_{b}"][v], rtol=NEGEV_ERR_REL, atol=TAIL_ERR_TOL)

    r_a, r_b, c_a, c_b, ja, jb = j["r_a"], j["r_b"], j["c_a"], j["c_b"], j["e_a"], j["e_b"]
    pick_rms = r_a <= r_b
    pick_neg = np.where((np.abs(r_a - r_b) < 0.5 * np.maximum(r_a, r_b)) & (c_a != c_b), c_a < c_b, pick_rms)
    changed = [(int(i), bool((ja[i] < jb[i]) == pick_neg[i])) for i in np.flatnonzero(v & (pick_rms != pick_neg))]
    assert [(r[0], r[-1]) for r in d["changed"]] == changed
    for k, pick in (("rms_pick_rmse", pick_rms), ("negev_pick_rmse", pick_neg)):
        assert d[k] == pytest.approx(_rmse(np.where(pick, ja, jb), v), rel=NEGEV_ERR_REL, abs=TAIL_ERR_TOL), k
    assert d["right_branch_with_contradictions"] == int(np.sum(v & (((ja < jb) & (c_a > 0)) | ((jb < ja) & (c_b > 0)))))
    assert d["scored"] == int(v.sum())
