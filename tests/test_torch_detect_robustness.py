"""The detector's robustness floors (``tests/test_detect_robustness.py``) held
on the port, in two arms, each with the JAX file's six tests:

* ``parity``: frames rendered and degraded by the JAX package (its noise
  from ``PRNGKey(7)`` and ``PRNGKey(11)``, which the port cannot draw),
  carried across as float32 numpy and detected by both detectors at
  ``quad_decimate=1`` on the CPU (JAX's through its XLA labelling, the
  port's through its plain CCL). Both must meet the floors; per scenario
  the port's found, expected and false-id counts and every frame's set of
  valid ids must equal JAX's, and its corner RMS must be within
  CORNER_TOL_PX of JAX's (measured gap: at most 0.005 px).
* ``own``: ``tools/probe_robustness_torch.py``'s sweep on the CPU, the
  port's own rasterizer and degradations (noise from a seeded
  ``torch.Generator``), the same floors; each of its rows must also carry
  ``floor_ok`` True. No parity: the two rasterizers differ within
  round-off (``test_render_frames_match``).

Scoring is ``tools/probe_robustness_torch.score``, the JAX file's
``_score``: detection rate, corner RMS against the analytic
``project_border_corners`` and false ids. Every test names its scenarios
as the sweep does; the parity arm degrades with the test's own recipe, the
own arm reads the sweep's row of that name.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.detect import DetectorParams as JDetectorParams
from aprilslam_tpu.detect import TagDetector as JTagDetector
from aprilslam_tpu.geometry import PinholeCamera as JCamera
from aprilslam_tpu import sim as jsim
from aprilslam_tpu.sim.config import TagConfig as JTagConfig
from aprilslam_tpu_torch.detect import DetectorParams, TagDetector

ROOT = Path(__file__).resolve().parents[1]
# The refined-corner tolerance of the detector's parity tests.
CORNER_TOL_PX = 0.1


def _load_probe():
    spec = importlib.util.spec_from_file_location("probe_robustness_torch",
                                                  ROOT / "tools" / "probe_robustness_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe = _load_probe()
score = probe.score
RES, POSES, PARAMS = probe.RES, probe.POSES, probe.DETECTOR


def _score(det_out, scene, gt_uv, gt_valid):
    """(found, expected, corner_rms, false_ids), as the JAX file's."""
    return score(det_out, scene, gt_uv, gt_valid)[:4]


def _jax_config(cfg):
    """The JAX package's SceneConfig of the port's ``cfg``."""
    d = dataclasses.asdict(cfg)
    return jsim.SceneConfig(**{**d, "tags": tuple(JTagConfig(**t) for t in d["tags"])})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops run fastest single-threaded on a shared host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class ParityArm:
    """JAX frames through both detectors. ``scores(name, fn)`` degrades the
    three clean frames with ``fn(degrade, frames, key)`` (JAX's module and
    ``jax.random.PRNGKey``), checks parity and returns each side's score."""

    sides = ("jax", "port")

    def __init__(self):
        with jax.enable_x64(False):
            cfg = jsim.SceneConfig.from_file()
            cam = JCamera.from_fov(RES, RES, cfg.fov_y)
            scene = jsim.scene_tensors(cfg)
            pos = jnp.asarray(POSES, jnp.float32)
            rot = jnp.zeros((3, 3), jnp.float32)
            self.frames = jsim.render_frames(scene, pos, rot, jnp.asarray(cam.inv_matrix), RES, RES, 2)
            gt_uv, gt_valid = jsim.project_border_corners(scene, pos, rot, jnp.asarray(cam.matrix))
            unocc = jsim.tags_unoccluded(scene.tag_pos, scene.tag_rot, pos, scene.inner_size, scene.outer_half)
            self.gt = (np.asarray(gt_uv), np.asarray(gt_valid & unocc))
        self.scene = scene
        self.dets = (JTagDetector(cfg.family, JDetectorParams(**PARAMS)),
                     TagDetector(cfg.family, DetectorParams(**PARAMS), device="cpu"))

    def _both(self, frames, dets, scene, gt_uv, gt_valid):
        with jax.enable_x64(False):
            jout = jax.device_get(dets[0].detect(frames))
        tout = dets[1].detect(np.array(frames, np.float32))
        j, t = _score(jout, scene, gt_uv, gt_valid), _score(tout, scene, gt_uv, gt_valid)
        assert (t[0], t[1], t[3]) == (j[0], j[1], j[3]), (j, t)
        assert probe.id_sets(tout) == probe.id_sets(jout)
        assert abs(t[2] - j[2]) <= CORNER_TOL_PX, (j[2], t[2])
        return [j, t]

    def scores(self, _name, fn):
        with jax.enable_x64(False):
            x = np.asarray(fn(jsim.degrade, self.frames, jax.random.PRNGKey))
        return self._both(x, self.dets, self.scene, *self.gt)

    def tilt_scores(self, tilt):
        with jax.enable_x64(False):
            cfg = _jax_config(probe.tilt_config(tilt))
            cam = JCamera.from_fov(RES, RES, cfg.fov_y)
            scene = jsim.scene_tensors(cfg)
            pos = jnp.asarray([[5.0, 0.0, 10.0]], jnp.float32)
            rot = jnp.zeros((1, 3), jnp.float32)
            frames = np.asarray(jsim.render_frames(scene, pos, rot, jnp.asarray(cam.inv_matrix), RES, RES, 2))
            gt_uv, gt_valid = jsim.project_border_corners(scene, pos, rot, jnp.asarray(cam.matrix))
        dets = (JTagDetector(cfg.family, JDetectorParams(**PARAMS)),
                TagDetector(cfg.family, DetectorParams(**PARAMS), device="cpu"))
        return self._both(frames, dets, scene, np.asarray(gt_uv), np.asarray(gt_valid))


class OwnArm:
    """The port's render, degradations and detector on the CPU: the rows of
    ``tools/probe_robustness_torch.py``'s sweep, by scenario name."""

    sides = ("port",)

    def __init__(self):
        self.rows = {row["name"]: row for row in probe.run("cpu")}

    def scores(self, name, _fn=None):
        row = self.rows[name]
        assert row["floor_ok"] is True, row
        return [(row["found"], row["expected"], row["rms"], row["false_ids"])]

    def tilt_scores(self, tilt):
        return self.scores(f"tilt{tilt:.0f}")


@pytest.fixture(scope="module", params=["parity", "own"])
def arm(request):
    return ParityArm() if request.param == "parity" else OwnArm()


class TestSensorNoise:
    def test_noise_sweep(self, arm):
        for sigma, min_rate, max_rms in [(0.02, 1.0, 0.6), (0.05, 1.0, 0.8), (0.10, 1.0, 1.0)]:
            for found, expected, rms, false_ids in arm.scores(
                    f"noise{sigma:.2f}", lambda dg, x, key: dg.gaussian_noise(x, sigma, key(7))):
                assert expected >= 5  # 6 unoccluded in-view tags over the 3 poses
                rate = found / expected
                assert rate >= min_rate, (sigma, rate)
                assert rms <= max_rms, (sigma, rms)
                assert false_ids == 0, (sigma, false_ids)


class TestBlur:
    def test_defocus_sweep(self, arm):
        for sigma, min_rate, max_rms in [(0.8, 1.0, 0.6), (1.5, 0.9, 1.2)]:
            for found, expected, rms, false_ids in arm.scores(
                    f"blur{sigma:.1f}", lambda dg, x, key: dg.gaussian_blur(x, sigma)):
                rate = found / expected
                assert rate >= min_rate, (sigma, rate)
                assert rms <= max_rms, (sigma, rms)
                assert false_ids == 0


class TestPhotometric:
    def test_brightness_gradient(self, arm):
        for strength in (0.3, 0.6):
            for found, expected, rms, false_ids in arm.scores(
                    f"gradient{strength:.1f}", lambda dg, x, key: dg.brightness_gradient(x, strength)):
                assert found / expected >= 0.9, strength
                assert rms <= 1.0, (strength, rms)
                assert false_ids == 0

    def test_gamma_and_vignette(self, arm):
        for gamma, vig in [(0.6, 0.3), (1.8, 0.4)]:
            for found, expected, rms, false_ids in arm.scores(
                    f"gamma{gamma:.1f}_vig{vig:.1f}", lambda dg, x, key: dg.vignette(dg.gamma_correct(x, gamma), vig)):
                assert found / expected >= 0.9, (gamma, vig)
                assert rms <= 1.0, (gamma, vig, rms)
                assert false_ids == 0


class TestObliqueAngles:
    def test_tilted_tags(self, arm):
        """Tags tilted 30-60 deg away from frontal: 30 and 45 deg fully
        detected with tight corners, 60 deg at least one tag."""
        results = {side: [] for side in arm.sides}
        for tilt in (30.0, 45.0, 60.0):
            for side, (found, expected, rms, false_ids) in zip(arm.sides, arm.tilt_scores(tilt)):
                results[side].append((tilt, found, expected, rms, false_ids))
                assert false_ids == 0
        for res in results.values():
            for tilt, found, expected, rms, _ in res[:2]:
                assert expected >= 2 and found == expected, (tilt, found, expected)
                assert rms <= 0.8, (tilt, rms)
            assert res[2][1] >= 1, res[2]


class TestCombinedDegradation:
    def test_realistic_sensor_stack(self, arm):
        """Everything at once at moderate levels: the 'cheap webcam' case."""
        def stack(dg, x, key):
            x = dg.gaussian_blur(x, 0.7)
            x = dg.brightness_gradient(x, 0.25)
            x = dg.vignette(x, 0.25)
            x = dg.gamma_correct(x, 1.4)
            return dg.gaussian_noise(x, 0.03, key(11))

        for found, expected, rms, false_ids in arm.scores("combined", stack):
            assert found / expected >= 0.9, (found, expected)
            assert rms <= 1.2, rms
            assert false_ids == 0
