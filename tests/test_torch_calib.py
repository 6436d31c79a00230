"""The port's Zhang calibration and calibration app against the JAX
package's, on the JAX test's synthetic views and on checkerboard images
made with OpenCV.

Tolerances: on the synthetic views the intrinsics (fx, fy, cx, cy) within
1e-2 px and the radial coefficients (k1, k2) within 1e-4 of the JAX
package's; both sides solve in float32 (the JAX side inside
``jax.enable_x64(False)``) and agree to about 4e-4 px and 3e-6. On the
warped checkerboard images the float32 LM of either side stops short of the
optimum, where float32 round-off in the cost hides the last steps (the
port's, with one thread, by 0.012 px and 1.7e-4 on k2; the JAX package's by
0.0015 px and 2.3e-5): both are held to a float64 solve of the same model
within 0.05 px and 5e-4."""

import logging
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu import calib as JC
from aprilslam_tpu.apps import calibrate as JAPP
from aprilslam_tpu.geometry import se3_exp as j_se3_exp
from aprilslam_tpu_torch import calib as TC
from aprilslam_tpu_torch.apps import calibrate as TAPP

K_TOL_PX = 1e-2
DIST_TOL = 1e-4
K_TOL_F64_PX = 0.05
DIST_TOL_F64 = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synthetic_views():
    """tests/test_calib.py's views: a 10x7 board through known intrinsics and
    radial distortion, seed 11."""
    rng = np.random.default_rng(11)
    K_true = np.array([[820.0, 0, 315.0], [0, 825.0, 245.0], [0, 0, 1]])
    k1, k2 = -0.12, 0.035
    obj = TC.board_points(10, 7, 25.0)
    views = []
    while len(views) < 8:
        xi = np.r_[rng.normal(scale=0.25, size=3), rng.normal(scale=40, size=2), 0]
        T = np.array(j_se3_exp(jnp.asarray(xi)))
        T[:3, 3] += [0, 0, rng.uniform(420, 700)]
        p = obj @ T[:3, :3].T + T[:3, 3]
        if p[:, 2].min() < 50:
            continue
        xy = p[:, :2] / p[:, 2:3]
        r2 = np.sum(xy**2, axis=-1, keepdims=True)
        xyd = xy * (1 + k1 * r2 + k2 * r2**2)
        uv = np.stack([K_true[0, 0] * xyd[:, 0] + K_true[0, 2],
                       K_true[1, 1] * xyd[:, 1] + K_true[1, 2]], axis=-1)
        if uv.min() < 5 or uv[:, 0].max() > 635 or uv[:, 1].max() > 475:
            continue
        views.append(uv.astype(np.float32))
    return K_true, (k1, k2), obj, views


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _assert_results_close(ours, ref):
    np.testing.assert_allclose(ours.camera_matrix, ref.camera_matrix, atol=K_TOL_PX)
    np.testing.assert_allclose(ours.dist_coeffs, ref.dist_coeffs, atol=DIST_TOL)


def test_board_points_match():
    np.testing.assert_array_equal(TC.board_points(10, 7, 25.0), JC.board_points(10, 7, 25.0))


def test_homography_and_closed_form_match_jax(synthetic_views):
    _K, _d, obj, views = synthetic_views
    with jax.enable_x64(False):
        jHs = [np.asarray(JC.homography_dlt(jnp.asarray(obj[:, :2]), jnp.asarray(v))) for v in views]
        jk4 = np.asarray(JC.intrinsics_from_homographies(jnp.asarray(np.stack(jHs))))
        jK0 = np.array([[jk4[0], 0, jk4[2]], [0, jk4[1], jk4[3]], [0, 0, 1]], np.float32)
        jTs = [np.asarray(JC.extrinsics_from_homography(jnp.asarray(H), jnp.asarray(jK0))) for H in jHs]
    tHs = torch.stack([TC.homography_dlt(_t(obj[:, :2]), _t(v)) for v in views])
    # H is normalised by H[2, 2], so the SVD's sign choice drops out.
    np.testing.assert_allclose(tHs.numpy(), np.stack(jHs), rtol=1e-3, atol=1e-4)
    tk4 = TC.intrinsics_from_homographies(tHs).numpy()
    np.testing.assert_allclose(tk4, jk4, atol=0.05)
    for H, jT in zip(jHs, jTs):
        tT = TC.extrinsics_from_homography(_t(H), _t(jK0)).numpy()
        np.testing.assert_allclose(tT[:3, :3], jT[:3, :3], atol=1e-4)
        np.testing.assert_allclose(tT[:3, 3], jT[:3, 3], atol=1e-2)
        np.testing.assert_array_equal(tT[3], [0, 0, 0, 1])


def test_homography_is_exact_on_an_undistorted_view(synthetic_views):
    K_true, _, obj, _views = synthetic_views
    p = obj + [0.0, 0.0, 500.0]
    uv = (p[:, :2] / p[:, 2:3]) @ np.diag([K_true[0, 0], K_true[1, 1]]) + [K_true[0, 2], K_true[1, 2]]
    H = TC.homography_dlt(_t(obj[:, :2]), _t(uv)).numpy()
    ph = np.concatenate([obj[:, :2], np.ones((len(obj), 1))], axis=-1) @ H.T
    assert np.abs(ph[:, :2] / ph[:, 2:3] - uv).max() < 0.05


@pytest.mark.parametrize("iters", [30, 40])
def test_calibrate_camera_matches_jax_and_truth(synthetic_views, iters):
    K_true, (k1, k2), obj, views = synthetic_views
    ours = TC.calibrate_camera(obj, views, iters=iters, device="cpu")
    with jax.enable_x64(False):
        ref = JC.calibrate_camera(obj, views, iters=iters)
    _assert_results_close(ours, ref)
    # tests/test_calib.py's bounds against the truth.
    assert ours.mean_reprojection_error < 0.1
    assert np.abs(ours.camera_matrix - K_true).max() < 4.0
    assert abs(ours.dist_coeffs[0] - k1) < 0.02 and abs(ours.dist_coeffs[1] - k2) < 0.03
    assert ours.per_view_errors.shape == (8,)
    assert ours.quality == ref.quality == "Excellent"


def test_quality_gates_and_npz_layout(synthetic_views, tmp_path):
    for err in (0.3, 0.7, 1.5, 3.0):
        assert TC.CalibrationResult.rate(err) == JC.CalibrationResult.rate(err)
    _K, _d, obj, views = synthetic_views
    res = TC.calibrate_camera(obj, views, iters=10, device="cpu")
    res.save_npz(str(tmp_path / "calib.npz"))
    z = np.load(tmp_path / "calib.npz")
    assert z["camera_matrix"].shape == (3, 3)
    assert z["dist_coeffs"].shape == (1, 5)  # the JAX package's layout


def _float64_solve(obj, pts):
    """[fx, fy, cx, cy, k1, k2] of the calibration model solved to
    convergence in float64 (scipy's LM), from the closed-form start."""
    from scipy.optimize import least_squares

    from aprilslam_tpu_torch.calib.zhang import _project_dist
    from aprilslam_tpu_torch.geometry import se3_log

    f64 = torch.float64
    V, N = len(pts), len(obj)
    Hs = torch.stack([TC.homography_dlt(torch.tensor(obj[:, :2], dtype=f64), torch.tensor(p, dtype=f64))
                      for p in pts])
    k4 = TC.intrinsics_from_homographies(Hs)
    K0 = torch.tensor([[k4[0], 0, k4[2]], [0, k4[1], k4[3]], [0, 0, 1]], dtype=f64)
    xi = se3_log(torch.stack([TC.extrinsics_from_homography(H, K0) for H in Hs]))
    x0 = torch.cat([k4, torch.zeros(2, dtype=f64), xi.reshape(-1)]).numpy()
    obj_rep = torch.tensor(obj, dtype=f64).repeat(V, 1)
    view_idx = torch.arange(V).repeat_interleave(N)
    uv = torch.tensor(np.stack(pts), dtype=f64).reshape(-1, 2)

    def residual(x):
        x = torch.tensor(x)
        return (_project_dist(x[:6], x[6:].reshape(V, 6), obj_rep, view_idx) - uv).reshape(-1).numpy()

    return least_squares(residual, x0, method="lm", xtol=1e-15, ftol=1e-15, gtol=1e-15).x[:6]


# ---- the calibration app on images ------------------------------------------

SQ_PX = 24  # board-image pixels per square
MARGIN = 2 * SQ_PX


def _board_image(cols=10, rows=7):
    """A checkerboard with cols x rows inner corners and a white margin."""
    h, w = (rows + 1) * SQ_PX + 2 * MARGIN, (cols + 1) * SQ_PX + 2 * MARGIN
    y, x = np.mgrid[:h, :w]
    sq = ((x - MARGIN) // SQ_PX + (y - MARGIN) // SQ_PX) % 2 == 0
    inside = (x >= MARGIN) & (x < w - MARGIN) & (y >= MARGIN) & (y < h - MARGIN)
    return np.where(inside & sq, 0, 255).astype(np.uint8)


def _shots(tmp_path):
    """Five views of the board through known poses, and one blank image."""
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    # Board-image pixel -> board mm (25 mm squares; inner corner (0, 0) at
    # MARGIN + SQ_PX), then mm -> camera pixels through K [r0 r1 t].
    s = 25.0 / SQ_PX
    A = np.array([[s, 0, -(MARGIN + SQ_PX) * s], [0, s, -(MARGIN + SQ_PX) * s], [0, 0, 1]])
    board = _board_image()
    paths = []
    for k, (rx, ry, tx, ty, tz) in enumerate([(0.0, 0.0, -110, -70, 520), (0.35, 0.0, -120, -60, 560),
                                              (0.0, -0.4, -100, -80, 540), (-0.3, 0.25, -130, -70, 600),
                                              (0.2, 0.35, -90, -90, 500)]):
        R = cv2.Rodrigues(np.array([rx, ry, 0.0]))[0]
        H = K @ np.column_stack([R[:, 0], R[:, 1], [tx, ty, tz]]) @ A
        img = cv2.warpPerspective(board, H, (640, 480), flags=cv2.INTER_LINEAR,
                                  borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        paths.append(str(tmp_path / f"shot_{k}.png"))
        cv2.imwrite(paths[-1], img)
    paths.append(str(tmp_path / "shot_blank.png"))
    cv2.imwrite(paths[-1], np.full((480, 640), 255, np.uint8))
    return paths


def test_calibrate_app_solve_matches_jax(tmp_path, caplog, monkeypatch):
    _shots(tmp_path)
    # OpenCV 5 returns corners as (N, 2), where OpenCV 4 gave (N, 1, 2); the
    # JAX package's frontend indexes [:, 0, :]. Its run gets the old shape.
    sub_pix = cv2.cornerSubPix
    common = ["solve", "--images", str(tmp_path / "shot_*.png")]
    with caplog.at_level(logging.INFO):
        rc_t = TAPP.main(["--device", "cpu", *common, "--out", str(tmp_path / "t" / "cal.npz"),
                          "--report-dir", str(tmp_path / "t_logs")])
        monkeypatch.setattr(cv2, "cornerSubPix", lambda *a: sub_pix(*a).reshape(-1, 1, 2))
        with jax.enable_x64(False):
            rc_j = JAPP.main(["--device", "cpu", *common, "--out", str(tmp_path / "j" / "cal.npz"),
                              "--report-dir", str(tmp_path / "j_logs")])
    assert rc_t == rc_j == 0
    ours, ref = np.load(tmp_path / "t" / "cal.npz"), np.load(tmp_path / "j" / "cal.npz")
    assert ours["dist_coeffs"].shape == ref["dist_coeffs"].shape == (1, 5)
    paths = sorted(str(p) for p in tmp_path.glob("shot_*.png"))
    pts, oks = TC.find_checkerboard_corners([cv2.imread(p) for p in paths])
    assert oks == [True] * 5 + [False]
    best = _float64_solve(TC.board_points(10, 7, 25.0), pts)
    for z in (ours, ref):
        K = z["camera_matrix"]
        np.testing.assert_allclose(K[[0, 1, 0, 1], [0, 1, 2, 2]], best[:4], atol=K_TOL_F64_PX)
        np.testing.assert_allclose(z["dist_coeffs"][0, :2], best[4:6], atol=DIST_TOL_F64)
    # The images' known camera, within a warp's resampling error.
    np.testing.assert_allclose(ours["camera_matrix"][[0, 1, 0, 1], [0, 1, 2, 2]],
                               [600.0, 600.0, 320.0, 240.0], atol=6.0)
    failed = (tmp_path / "t_logs" / "failed_images.txt").read_text()
    assert failed == (tmp_path / "j_logs" / "failed_images.txt").read_text()
    assert failed == str(tmp_path / "shot_blank.png")
    assert "corners found in 5/6 images" in caplog.text


def test_calibrate_app_needs_three_views(tmp_path):
    cv2.imwrite(str(tmp_path / "blank.png"), np.full((48, 64), 255, np.uint8))
    rc = TAPP.main(["--device", "cpu", "solve", "--images", str(tmp_path / "*.png"),
                    "--out", str(tmp_path / "cal.npz"), "--report-dir", str(tmp_path / "logs")])
    assert rc == 2 and not os.path.exists(tmp_path / "cal.npz")
    assert (tmp_path / "logs" / "failed_images.txt").read_text() == str(tmp_path / "blank.png")
