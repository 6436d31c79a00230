"""The plain reference on answers whose truth is known by construction."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.inputs import scene as S
from perfbench.reference import geometry as g
from perfbench.reference import judge, pnp

K = S.intrinsics(1000, 1000, 45.0)


@pytest.fixture(scope="module")
def truth():
    scene = S.Scene(harness.load_json(harness.HERE / "inputs" / "default_scene.json"))
    pos, rot = S.monte_carlo(64, seed=2**31 + 5)
    return scene, pos, rot, judge.ground_truth(scene, pos, rot, K)


def exact_answers(gt, scene, D=16):
    c = judge.control_detections(gt, scene, 1000, 1000, torch.float64, D)
    return c["ids"].numpy(), c["corners"].numpy(), c["ok"].numpy()


def test_exact_detections_pass_and_a_moved_one_fails(truth):
    scene, pos, rot, gt = truth
    ids, corners, ok = exact_answers(gt, scene)
    r = judge.judge_detections(ids, corners, ok, gt, scene, 1000, 1000, 10.0, 4.0)
    assert r["false_dets"] == 0 and r["missed_share"] == 0.0 and r["corner_rms_px"] < 1e-9
    assert r["expected_tags"] > 64
    b, d = np.argwhere(ids >= 0)[0]
    moved = corners.copy()
    moved[b, d] += 5.0
    wrong = ids.copy()
    wrong[b, d + 1 if ids[b, d + 1] < 0 else d] = 99
    assert judge.judge_detections(ids, moved, ok, gt, scene, 1000, 1000, 10.0, 4.0)["false_dets"] == 1
    assert judge.judge_detections(wrong, corners, ok, gt, scene, 1000, 1000, 10.0, 4.0)["false_dets"] == 1
    half = ok.copy()
    half[32:] = False
    assert judge.judge_detections(ids, corners, half, gt, scene, 1000, 1000, 10.0, 4.0)["missed_share"] > 0.3


def test_a_detection_the_program_vouches_for_sits_on_its_tag_at_the_frame_edge_too():
    """A tag whose inner border touches the frame's left edge: the detector
    put one corner 21 px astray and PnP vouched for the pose (a frame of the
    card's run). That is a false detection; the same corners not vouched
    for only have to name the tag under them."""
    scene = S.Scene(harness.load_json(harness.HERE / "inputs" / "default_scene.json"))
    pos = np.array([[13.414602, -0.5406804, -5.378808]], dtype=np.float32)
    gt = judge.ground_truth(scene, pos, np.zeros((1, 3), np.float32), K)
    assert np.allclose(gt["uv"][0, 0].numpy(), [[1.8, 620.6], [272.4, 620.6], [272.4, 350.1], [1.8, 350.1]],
                       atol=0.1)
    corners = np.zeros((1, 2, 4, 2))
    corners[0, 0] = [[1.4, 620.3], [272.5, 620.5], [272.5, 350.0], [23.0, 350.0]]
    corners[0, 1] = gt["uv"][0, 2].numpy()
    ids = np.array([[0, 2]])
    judged = lambda ids, c, ok: judge.judge_detections(ids, c, ok, gt, scene, 1000, 1000, 10.0, 4.0)  # noqa: E731
    assert judged(ids, corners, np.array([[True, True]]))["false_dets"] == 1
    assert judged(ids, corners, np.array([[False, True]]))["false_dets"] == 0
    assert judged(np.array([[1, 2]]), corners, np.array([[False, True]]))["false_dets"] == 1
    astray = corners.copy()
    astray[0, 1, 3] += [21.6, 0.0]
    assert judged(ids, astray, np.array([[False, True]]))["false_dets"] == 1
    assert judged(ids, astray, np.array([[False, False]]))["false_dets"] == 0


def true_map_by_slot(scene, M=16):
    W = judge.true_map(scene)
    lm = torch.eye(4, dtype=torch.float64).repeat(M, 1, 1)
    lm[torch.as_tensor(scene.tag_ids())] = W
    active = torch.zeros(M, dtype=torch.bool)
    active[torch.as_tensor(scene.tag_ids())] = True
    return lm, active


def test_the_map_is_held_against_the_scene_in_any_gauge():
    scene = S.Scene(harness.load_json(harness.HERE / "inputs" / "default_scene.json"))
    lm, active = true_map_by_slot(scene)
    # The program's world frame is its anchor's: any rigid motion of the whole map.
    G = g.make_se3(g.tag_rotation(torch.tensor([[10.0, -30.0, 5.0]], dtype=torch.float64))[0],
                   torch.tensor([3.0, -7.0, 40.0], dtype=torch.float64))
    maps = torch.stack([lm, G @ lm])
    r = judge.judge_map(maps, active.expand(2, -1), scene)
    assert r["map_rms_su"] < 1e-9 and r["map_landmarks"] == 8
    moved = maps.clone()
    moved[1, 3, :3, 3] += torch.tensor([0.0, 3.0, 4.0], dtype=torch.float64)
    r = judge.judge_map(moved, active.expand(2, -1), scene)
    assert r["map_max_su"] == pytest.approx(5.0) and r["map_rms_su"] == pytest.approx(5.0 / 8 ** 0.5)
    stray = active.clone()
    stray[9] = True  # a landmark no scene tag bears
    assert judge.judge_map(maps, stray.expand(2, -1), scene)["map_rms_su"] == float("inf")
    # A state that never moved has no landmark at all.
    assert judge.judge_map(maps, torch.zeros(2, 16, dtype=torch.bool), scene)["map_rms_su"] == float("inf")


def test_the_control_map_is_the_scene_in_float64_and_is_not_in_bfloat16(truth):
    scene, pos, rot, gt = truth
    _, active = true_map_by_slot(scene)
    act = active.expand(3, -1)
    exact = judge.control_map(act, gt, scene, K, 1000, 1000, torch.float64)
    assert judge.judge_map(exact, act, scene)["map_rms_su"] < 1e-6
    rough = judge.control_map(act, gt, scene, K, 1000, 1000, torch.bfloat16)
    assert judge.judge_map(rough, act, scene)["map_rms_su"] > 0.5


def test_a_tag_behind_another_is_not_expected():
    scene = S.Scene(harness.load_json(harness.HERE / "inputs" / "default_scene.json"))
    # Straight in front of tag 0 (at z=-50), tag 1 (x=-30, z=-120) is not behind it;
    # from far along the line through both, tag 0 hides tag 1.
    p0, p1 = scene.tag_positions()[0].astype(float), scene.tag_positions()[1].astype(float)
    cam = p0 + (p0 - p1) * 0.2
    occ = judge.unoccluded(scene, torch.as_tensor(cam[None]))
    assert occ[0, 0] and not occ[0, 1]
    assert judge.unoccluded(scene, torch.tensor([[0.0, 0.0, 10.0]], dtype=torch.float64))[0, 0]


def test_the_reference_pnp_recovers_exact_poses_and_bf16_does_not(truth):
    scene, pos, rot, gt = truth
    vis = (gt["z"] > 0).all(-1)
    T_true = gt["T_ct"][vis]
    uv = gt["uv"][vis]
    T, rms = pnp.tag_pose(uv, scene.tag_size_inner, K)
    assert float(rms.max()) < 1e-6
    assert float((T[:, :3, 3] - T_true[:, :3, 3]).norm(dim=-1).max()) < 1e-4
    assert float(pnp.tag_pose_gap(T_true, uv, scene.tag_size_inner, K).max()) < 1e-6
    Tb, _ = pnp.tag_pose(uv.to(torch.bfloat16), scene.tag_size_inner, K)
    assert float(pnp.tag_pose_gap(Tb.double(), uv, scene.tag_size_inner, K).median()) > 0.3


def test_the_camera_solve_on_a_known_map(truth):
    scene, pos, rot, gt = truth
    # The map in tag 0's frame: each tag's pose there, as the SLAM back end keeps it.
    T_ct = gt["T_ct"]  # (N, T, 4, 4)
    world = g.se3_inverse(T_ct[0, 0])[None] @ T_ct[0]  # (T, 4, 4) tag -> tag-0 frame
    N, T = T_ct.shape[:2]
    use = ((gt["z"] > 0).all(-1) & gt["unoccluded"])
    use = use & use.any(-1, keepdim=True)
    lm = world[None].expand(N, T, 4, 4)
    T_cw = T_ct[:, 0] @ g.se3_inverse(world[0])[None]  # camera <- world
    gap = pnp.camera_gap(T_cw[use.any(-1)], lm[use.any(-1)], use[use.any(-1)], gt["uv"][use.any(-1)],
                         scene.tag_size_inner, K)
    assert float(gap.max()) < 1e-6
    # A pose that refining from itself cannot mend (the camera turned about,
    # every tag behind it) is held against the reference's own solve.
    turned = g.make_se3(g.tag_rotation(torch.tensor([[0.0, 180.0, 0.0]], dtype=torch.float64))[0],
                        torch.zeros(3, dtype=torch.float64)) @ T_cw[use.any(-1)]
    gap = pnp.camera_gap(turned, lm[use.any(-1)], use[use.any(-1)], gt["uv"][use.any(-1)],
                         scene.tag_size_inner, K)
    assert float(gap.min()) > 10.0
    got = pnp.camera_pose(lm[use.any(-1)], use[use.any(-1)], gt["uv"][use.any(-1)], scene.tag_size_inner, K)
    assert float((got - T_cw[use.any(-1)]).abs().max()) < 1e-5


def test_the_elimination_solves_spd_systems_in_any_dtype():
    A = torch.tensor([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]], dtype=torch.float64)
    b = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert torch.allclose(g.solve_spd(A, b), torch.linalg.solve(A, b))
    assert torch.allclose(g.solve_spd(A.bfloat16(), b.bfloat16()).double(), torch.linalg.solve(A, b), atol=0.05)
