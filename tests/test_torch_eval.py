"""Port parity: evaluation (metrics, the CSV logger, the offline analytics)."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu import eval as JE
from aprilslam_tpu.geometry import se3_exp
from aprilslam_tpu_torch import eval as TE


def _poses(rng, n):
    xi = np.concatenate([rng.normal(scale=0.8, size=(n, 3)),
                         rng.normal(scale=20.0, size=(n, 3))], -1).astype(np.float32)
    with jax.enable_x64(False):
        return np.array(se3_exp(jnp.asarray(xi)))


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _log_rows(logger_cls, out_dir, rng):
    """The same frame and node rows through one package's DataLogger."""
    est, gt = _poses(rng, 12), _poses(rng, 12)
    gt[3] = np.eye(4)  # the GT of a frame with no anchor, as the CLI writes it
    gt64 = gt.astype(np.float64)  # the CLI's GT array is float64
    with logger_cls(str(out_dir), flush_every=4) as lg:
        for i in range(12):
            lg.log_frame(est[i], gt64[i], i % 5, 3.0 + i, t=0.1 * i, reproj_rms=0.01 * i)
            lg.log_node(float(1 + i % 3), est[(i + 1) % 12], est[(i + 2) % 12], gt[i],
                        0.5 * i, 0.25 * i, 0.125 * i)
        stats = lg.get_statistics()
    return stats


def test_logger_writes_the_same_csvs(tmp_path):
    with jax.enable_x64(False):
        js = _log_rows(JE.DataLogger, tmp_path / "jax", np.random.default_rng(0))
    ts = _log_rows(TE.DataLogger, tmp_path / "torch", np.random.default_rng(0))
    assert js["frames_logged"] == ts["frames_logged"] == 12
    for name, header in (("slam_simulation_data.csv", TE.MAIN_HEADER),
                         ("error_analysis.csv", TE.ERROR_HEADER),
                         ("covariance_analysis.csv", TE.COV_HEADER)):
        want, got = _read(tmp_path / "jax" / name), _read(tmp_path / "torch" / name)
        assert got[0] == want[0] == header
        assert len(got) == len(want) == 13
        skip = {"Time"}
        cols = [k for k, h in enumerate(header) if h not in skip]
        w = np.array([[float(r[k]) for k in cols] for r in want[1:]])
        g = np.array([[float(r[k]) for k in cols] for r in got[1:]])
        # Both round to 6 decimals, so one ulp of float32 can flip the last one.
        np.testing.assert_allclose(g, w, atol=1e-6 + 1e-12, rtol=0, err_msg=name)


def test_headers_and_metrics_are_the_reference_ones():
    assert (TE.MAIN_HEADER, TE.ERROR_HEADER, TE.COV_HEADER) == (JE.MAIN_HEADER, JE.ERROR_HEADER,
                                                                JE.COV_HEADER)
    rng = np.random.default_rng(3)
    est, gt = _poses(rng, 20), _poses(rng, 20)
    est[4, 0, 3] = np.nan  # a diverged frame is left out of the alignment
    want, got = JE.trajectory_report(est, gt, 5.56), TE.trajectory_report(est, gt, 5.56)
    assert got.keys() == want.keys()
    for k in ("translation", "rotation", "translation_mm"):
        np.testing.assert_equal(got[k], want[k])
    np.testing.assert_equal(got["ate_rmse_aligned"], want["ate_rmse_aligned"])
    assert TE.percentage_error(1.0, 4.0) == JE.percentage_error(1.0, 4.0) == 25.0


def _features(seed=0, n=60, d=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32) * np.arange(1, d + 1, dtype=np.float32)


def test_standardize_and_pca_up_to_sign():
    X = _features()
    with jax.enable_x64(False):
        jXs, _, _ = JE.standardize(jnp.asarray(X))
        jp, jc, jv = (np.asarray(a) for a in JE.pca(jXs, 3))
    tXs, _, _ = TE.standardize(torch.from_numpy(X))
    np.testing.assert_allclose(tXs.numpy(), np.asarray(jXs), atol=1e-5)
    tp, tc, tv = (a.numpy() for a in TE.pca(tXs, 3))
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    sign = np.sign(np.sum(tc * jc, axis=1))
    assert np.all(sign != 0)
    np.testing.assert_allclose(tc * sign[:, None], jc, atol=1e-4)
    np.testing.assert_allclose(tp * sign[None, :], jp, atol=1e-4)


def test_kmeans_up_to_label_permutation():
    """Both initial draws are seeded but differ (jax.random against a torch
    Generator), so the labels agree only up to a permutation. Lloyd's stops
    in a local minimum when two initial centres land in one blob, in either
    package; on these blobs both draws find all three."""
    rng = np.random.default_rng(2)
    centres = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0], [0.0, 10.0, 5.0]], np.float32)
    X = np.concatenate([c + rng.normal(scale=0.5, size=(40, 3)) for c in centres]).astype(np.float32)
    truth = np.repeat(np.arange(3), 40)
    order = rng.permutation(len(X))
    X, truth = X[order], truth[order]
    with jax.enable_x64(False):
        jl, jc = (np.asarray(a) for a in JE.kmeans(jnp.asarray(X), 3))
    tl, tc = (a.numpy() for a in TE.kmeans(torch.from_numpy(X), 3))
    # The label -> label map is one to one, and the centres agree under it.
    perm = {int(a): int(b) for a, b in zip(tl, jl)}
    assert sorted(perm) == sorted(perm.values()) == [0, 1, 2]
    np.testing.assert_array_equal(np.vectorize(perm.get)(tl), jl)
    assert len(set(zip(tl, truth))) == 3  # the blobs themselves
    np.testing.assert_allclose(tc[list(perm)], jc[list(perm.values())], atol=1e-4)


def test_linear_regression():
    X = _features(2)
    rng = np.random.default_rng(2)
    y = (X @ np.array([0.5, -1.0, 0.25, 0.0, 2.0], np.float32) + 3.0
         + rng.normal(scale=0.1, size=len(X))).astype(np.float32)
    with jax.enable_x64(False):
        jw, jb, js = (np.asarray(a) for a in JE.linear_regression(jnp.asarray(X), jnp.asarray(y)))
    tw, tb, ts = (a.numpy() for a in TE.linear_regression(torch.from_numpy(X), torch.from_numpy(y)))
    np.testing.assert_allclose(tw, jw, atol=1e-4)
    np.testing.assert_allclose(tb, jb, atol=1e-4)
    np.testing.assert_allclose(ts, js, atol=1e-4)


@pytest.fixture()
def logged_csvs(tmp_path):
    _log_rows(TE.DataLogger, tmp_path, np.random.default_rng(5))
    return tmp_path


def test_error_analysis_and_covariance_report(logged_csvs, tmp_path):
    main = str(logged_csvs / "slam_simulation_data.csv")
    with jax.enable_x64(False):
        want = JE.error_analysis(main, output_csv=str(tmp_path / "jax_clustered.csv"))
    got = TE.error_analysis(main, output_csv=str(tmp_path / "torch_clustered.csv"))
    assert got.coefficients.keys() == want.coefficients.keys()
    for k, v in want.coefficients.items():
        assert got.coefficients[k] == pytest.approx(v, abs=1e-4), k
    assert got.mse == pytest.approx(want.mse, abs=1e-4)
    assert got.r2 == pytest.approx(want.r2, abs=1e-4)
    np.testing.assert_allclose(got.explained_variance, want.explained_variance, atol=1e-4)
    sign = np.sign(np.sum(got.pca_proj * want.pca_proj, axis=0))
    np.testing.assert_allclose(got.pca_proj * sign, want.pca_proj, atol=1e-4)
    rows = _read(got.output_csv)
    assert rows[0][-3:] == ["PCA1", "PCA2", "Cluster"] and len(rows) == 13

    cov = str(logged_csvs / "covariance_analysis.csv")
    want, got = JE.covariance_report(cov), TE.covariance_report(cov)
    assert got.keys() == want.keys() and "Tag_Est_X" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-4), k


def test_covariance_dashboard(logged_csvs, tmp_path):
    from aprilslam_tpu_torch.viz import render_covariance_dashboard, watch

    cov = str(logged_csvs / "covariance_analysis.csv")
    render_covariance_dashboard(cov, save_path=str(tmp_path / "cov.png"))
    assert (tmp_path / "cov.png").stat().st_size > 0
    fig = watch(cov, save_path=str(tmp_path / "watch.png"), poll_s=0.0, max_iterations=2)
    assert fig is not None and (tmp_path / "watch.png").stat().st_size > 0
