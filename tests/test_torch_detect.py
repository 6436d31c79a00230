"""Port parity: the detector, stage by stage and end to end, on the same
JAX-rendered uint8 frames.

Where parity cannot be bit for bit: the reference sorts boundary points
with an unstable sort (quads.py:210-212), so the order of points inside a
cluster — and with it which points the stride subsample feeds the quad fit
— is not reproducible; the port sorts stably. So the cluster statistics
that do not depend on that order are compared exactly, the quad fit on
identical point sets, decode and refinement on identical quads, and the
end-to-end detections after full-resolution refinement (ids and validity
exactly, corners to 0.1 px).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams, detect_fn
from aprilslam_tpu.detect import decode as JD
from aprilslam_tpu.detect import quads as JQ
from aprilslam_tpu.detect import threshold as JT
from aprilslam_tpu.detect.refine import refine_corners
from aprilslam_tpu.detect.segment import connected_components as cc_xla
from aprilslam_tpu.families import get_family
from aprilslam_tpu.geometry import PinholeCamera
from aprilslam_tpu.sim import SceneConfig, render_frames, scene_tensors, trajectory
from aprilslam_tpu_torch import detect as TD
from aprilslam_tpu_torch.detect import quads as TQ
from aprilslam_tpu_torch.families import get_family as t_get_family

RES = 384
PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16, max_boundary=8192)
QUAD_KW = dict(max_clusters=PARAMS.max_clusters, max_quads=PARAMS.max_quads,
               pts_per_quad=PARAMS.pts_per_quad, min_cluster_pts=PARAMS.min_cluster_pts,
               min_side=PARAMS.min_side, refine_iters=PARAMS.refine_iters,
               max_fit_err=PARAMS.max_fit_err, max_boundary=PARAMS.max_boundary)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def ref():
    """Frames rendered by the JAX package and every intermediate of its
    detector, computed once (one jit) in float32."""
    cfg = SceneConfig.from_file()
    cam = PinholeCamera.from_fov(RES, RES, cfg.fov_y)
    traj = trajectory.scripted_line(4, np.array([0.0, 0.0, 20.0]), np.array([8.0, 2.0, -10.0]))
    fam = JD.FamilyTensors(get_family(cfg.family))

    def stages(frames):
        gray = JT.to_grayscale(frames)
        dec = JT.decimate(gray, PARAMS.quad_decimate)
        trin, level = JT.adaptive_threshold_with_levels(dec, tile=PARAMS.tile,
                                                        min_contrast=PARAMS.min_contrast)
        labels = cc_xla(trin, PARAMS.scan_iters, PARAMS.jump_iters)
        quads = JQ.quad_candidates(trin, labels, dec, PARAMS.quad_decimate, level, **QUAD_KW)
        raw = JD.decode_quads(gray, quads, fam, max_hamming=PARAMS.max_hamming,
                              min_level_contrast=PARAMS.min_level_contrast,
                              max_detections=PARAMS.max_detections)
        refined = refine_corners(gray, raw.corners, raw.valid, ns=PARAMS.refine_samples,
                                 half_range=PARAMS.refine_range)
        bnd = JQ._emit_boundaries(trin, labels, dec, level)
        return gray, dec, trin, level, labels, quads, raw, refined, bnd

    with jax.enable_x64(False):
        frames = render_frames(scene_tensors(cfg), jnp.asarray(traj.positions),
                               jnp.asarray(traj.rotations), jnp.asarray(cam.inv_matrix), RES, RES, 2)
        u8 = jnp.clip(frames * 255.0, 0, 255).astype(jnp.uint8)
        out = jax.jit(stages)(u8)
        det = jax.jit(detect_fn(cfg.family, PARAMS))(u8)
        out, det = jax.device_get((out, det))
    gray, dec, trin, level, labels, quads, raw, refined, bnd = out
    return SimpleNamespace(cfg=cfg, u8=np.asarray(u8), gray=gray, dec=dec, trin=trin, level=level,
                           labels=labels, quads=quads, raw=raw, refined=refined, bnd=bnd, det=det)


def test_threshold(ref):
    gray = TD.to_grayscale(t(ref.u8))
    np.testing.assert_array_equal(gray.numpy(), ref.gray)
    dec = TD.decimate(gray, PARAMS.quad_decimate)
    np.testing.assert_array_equal(dec.numpy(), ref.dec)  # same contraction order
    trin, level = TD.adaptive_threshold_with_levels(dec, tile=PARAMS.tile,
                                                    min_contrast=PARAMS.min_contrast)
    assert trin.dtype == torch.int8
    np.testing.assert_array_equal(trin.numpy(), ref.trin)
    np.testing.assert_allclose(level.numpy(), ref.level, atol=1e-6)


def test_noise_sigma_is_jnp_median():
    rng = np.random.default_rng(3)
    x = rng.random((3, 64, 72), dtype=np.float32)  # 16x18 subsample: even count
    with jax.enable_x64(False):
        a = np.asarray(JT.estimate_noise_sigma(jnp.asarray(x)))
    np.testing.assert_array_equal(TD.threshold.estimate_noise_sigma(t(x)).numpy(), a)


def test_labels_converged_on_these_frames(ref):
    """Precondition of the end-to-end comparison: the JAX CPU detector's
    4-iteration XLA labelling has converged on these frames, so it equals
    the port's converged labels."""
    got = TD.connected_components(t(ref.trin))
    np.testing.assert_array_equal(got.numpy(), ref.labels)


def test_boundaries_and_compaction(ref):
    ka, kb, x, y, w = TQ._emit_boundaries(t(ref.trin), t(ref.labels), t(ref.dec), t(ref.level))
    for got, want in zip((ka, kb, x, y, w), ref.bnd):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = TQ._compact(ka, kb, x, y, w, PARAMS.max_boundary)
    with jax.enable_x64(False):
        for b in range(ka.shape[0]):
            jc = jax.device_get(JQ._compact(*[jnp.asarray(a[b]) for a in ref.bnd],
                                            PARAMS.max_boundary))
            live = jc[0] < JQ._BIG
            np.testing.assert_array_equal(c[0][b].numpy(), jc[0])
            np.testing.assert_array_equal(c[1][b].numpy(), jc[1])
            for k in (2, 3, 4):  # payload of live slots; dead slots carry weight 0
                np.testing.assert_array_equal(c[k][b].numpy()[live], jc[k][live])
            np.testing.assert_array_equal(c[4][b].numpy(), jc[4])


@pytest.mark.parametrize("source", ["frames", "random_keys"])
def test_cluster_stats_exact(ref, source):
    """Per-cluster count, start and bounding box do not depend on the order
    inside a cluster, so they match exactly."""
    if source == "frames":
        cols = TQ._compact(*[t(a) for a in ref.bnd], PARAMS.max_boundary)
    else:  # many ties, invalid keys and unsorted input
        rng = np.random.default_rng(11)
        n = 2048
        ka = rng.integers(0, 12, size=(2, n)).astype(np.int32)
        kb = rng.integers(0, 4, size=(2, n)).astype(np.int32)
        dead = rng.random((2, n)) < 0.3
        ka[dead], kb[dead] = JQ._BIG, JQ._BIG
        xyw = rng.random((3, 2, n), dtype=np.float32)
        cols = [t(ka), t(kb)] + [t(v) for v in xyw]
    _, st = TQ._cluster(*cols, PARAMS.max_clusters, PARAMS.min_cluster_pts)
    with jax.enable_x64(False):
        for b in range(cols[0].shape[0]):
            _, jst = JQ._cluster(*[jnp.asarray(c[b].numpy()) for c in cols],
                                 PARAMS.max_clusters, PARAMS.min_cluster_pts)
            for k, v in jax.device_get(jst).items():
                np.testing.assert_array_equal(st[k][b].numpy(), v, err_msg=k)


def test_fit_quad_same_points():
    """Identical point sets: noisy samples along the edges of random convex
    quads, with zero-weight padding."""
    rng = np.random.default_rng(2)
    Q, P = 24, 128
    pts = np.zeros((Q, P, 2), np.float32)
    for q in range(Q):
        c = rng.uniform(20, 80, size=2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 4) + np.arange(4) * 0.2)
        corners = c + rng.uniform(8, 20, size=(4, 1)) * np.stack([np.cos(ang), np.sin(ang)], -1)
        s = rng.random(P)
        e = rng.integers(0, 4, P)
        pts[q] = corners[e] + s[:, None] * (np.roll(corners, -1, 0)[e] - corners[e])
    pts += rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(Q, P)).astype(np.float32)
    w[:, 100:] = 0.0
    with jax.enable_x64(False):
        jc, jr = jax.device_get(jax.vmap(lambda p, ww: JQ._fit_quad(p, ww, 2))(
            jnp.asarray(pts), jnp.asarray(w)))
    tc, tr = TQ._fit_quad(t(pts), t(w), 2)
    # float32 moments summed in another order feed arctan2/intersections,
    # and a point whose angle sits on a side boundary within round-off can
    # switch sides.
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-2)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-4)


@pytest.mark.parametrize("side", [64, 65, 96])
def test_axis_aligned_square_keeps_all_sides(side):
    """A black axis-aligned square on white, its boundary 2x to 3x
    ``pts_per_quad`` points: the stride subsample must see all four sides.
    In emission order the left and right edges alternate row by row, and a
    stride of 2 would keep only the left one (the fit then diverges)."""
    H = W = 160
    gray = np.ones((1, H, W), np.float32)
    gray[0, 32:32 + side, 40:40 + side] = 0.0
    trin = torch.as_tensor(gray > 0.5).to(torch.int8)
    labels = TD.connected_components(trin)
    q = TQ.quad_candidates(trin, labels, torch.as_tensor(gray), 1, torch.full((1, H, W), 0.5),
                           **QUAD_KW)
    assert int(q.valid.sum()) == 1
    k = int(q.valid[0].nonzero()[0, 0])
    assert int(q.cluster_size[0, k]) >= 2 * PARAMS.pts_per_quad
    want = np.array([[40, 32], [40 + side, 32], [40 + side, 32 + side], [40, 32 + side]], np.float32)
    got = q.corners[0, k].numpy()
    for c in want:  # cyclic order and starting corner are the fit's own
        assert np.abs(got - c).max(axis=-1).min() < 1e-3, (got, want)


def test_family_tensors():
    fj = JD.FamilyTensors(get_family("tagStandard41h12"))
    ft = TD.FamilyTensors(t_get_family("tagStandard41h12"), device="cpu")
    for k in ("templates", "meta", "sample_pts", "mask_flat", "black_flat", "white_flat", "mask_idx"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)), err_msg=k)
    assert (ft.n_codes, ft.d_bits) == (fj.n_codes, fj.d_bits)


def test_decode_same_quads(ref):
    q = ref.quads
    tq = TQ.QuadCandidates(t(q.corners), t(q.valid), t(q.fit_err), t(q.cluster_size))
    ft = TD.FamilyTensors(t_get_family(ref.cfg.family), device="cpu")
    got = TD.decode_quads(t(ref.gray), tq, ft, max_hamming=PARAMS.max_hamming,
                          min_level_contrast=PARAMS.min_level_contrast,
                          max_detections=PARAMS.max_detections)
    for k in ("ids", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(ref.raw, k), err_msg=k)
    v = ref.raw.valid
    assert v.sum() >= 8
    # Invalid slots hold whatever degenerate (non-finite) quads decode to.
    for k in ("hamming", "margin"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[v], getattr(ref.raw, k)[v], err_msg=k)
    np.testing.assert_array_equal(got.corners.numpy()[v], ref.raw.corners[v])
    np.testing.assert_allclose(got.homography.numpy()[v], ref.raw.homography[v], rtol=1e-4, atol=1e-3)


def test_refine_same_corners(ref):
    got = TD.refine_corners(t(ref.gray), t(ref.raw.corners), t(ref.raw.valid),
                            ns=PARAMS.refine_samples, half_range=PARAMS.refine_range)
    v = ref.raw.valid
    np.testing.assert_allclose(got.numpy()[v], ref.refined[v], atol=1e-3)


def test_detect_fn_end_to_end(ref):
    params = TD.DetectorParams(**PARAMS.__dict__)
    det = TD.TagDetector(ref.cfg.family, params, device="cpu").detect(ref.u8)
    np.testing.assert_array_equal(det.ids.numpy(), ref.det.ids)
    np.testing.assert_array_equal(det.valid.numpy(), ref.det.valid)
    v = ref.det.valid
    assert v.sum() >= 8
    # Pre-refinement corners differ with the sort-order gap (module doc);
    # full-resolution refinement re-localizes the edges from the image.
    np.testing.assert_allclose(det.corners.numpy()[v], ref.det.corners[v], atol=0.1)
