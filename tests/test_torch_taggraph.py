"""Port parity: the landmark pose graph (``slam/taggraph.py``) against the
JAX package.

Chunks of co-visible detections with duplicate pairs, outlier branches, a
pair whose reference is itself an outlier (until it resets) and more pairs
than the compaction budget; then the edges and a solve with held tags.
Counts and rejections must match exactly, pair means to 1e-4. Pair means
(``ref_T @ exp(sum_dev / count)``) are compared, not ``ref_T`` itself:
which of several first sightings becomes the reference is the scatter's
choice. Each chunk restarts the port from the JAX state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aprilslam_tpu.geometry import se3_exp
from aprilslam_tpu.slam import taggraph as JT
from aprilslam_tpu_torch import slam as TS
from aprilslam_tpu_torch.convert import _from_numpy
from aprilslam_tpu_torch.geometry import se3_exp as t_se3_exp

M, B, D = 8, 4, 6


def np_state(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def to_port(arrays):
    return _from_numpy(TS.TagGraphState, arrays, torch.device("cpu"))


def exp_np(xi):
    with jax.enable_x64(False):
        return np.array(se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def means(tg: dict) -> np.ndarray:
    """(M, M, 4, 4) pair means from the accumulator's fields."""
    dev = tg["sum_dev"] / np.maximum(tg["count"], 1.0)[..., None]
    return np.einsum("abij,abjk->abik", tg["ref_T"], t_se3_exp(torch.as_tensor(dev)).numpy())


def chunks():
    """Four chunks of B frames; tag world poses fixed, camera moving."""
    rng = np.random.default_rng(11)
    lm = exp_np(np.concatenate([rng.normal(scale=0.2, size=(M, 3)), rng.normal(scale=8.0, size=(M, 3))], -1))
    out = []
    for c in range(4):
        ids = np.full((B, D), -1, np.int32)
        T = np.tile(np.eye(4, dtype=np.float32), (B, D, 1, 1))
        rel = np.zeros((B, D), bool)
        for b in range(B):
            cam = exp_np(np.concatenate([rng.normal(scale=0.1, size=3), rng.normal(scale=2.0, size=3)]))
            seen = np.sort(rng.choice(M, size=5, replace=False))
            if c == 0 and b == 1:
                seen = np.array([0, 1, 2, 3])
            if c >= 1 and b == 0:  # duplicate sightings of the pair (6, 7)
                seen = np.array([6, 7, 6, 7, 0])
            for k, m in enumerate(seen):
                ids[b, k] = m
                noise = exp_np(np.concatenate([rng.normal(scale=0.002, size=3), rng.normal(scale=0.02, size=3)]))
                T[b, k] = np.linalg.inv(cam) @ lm[m] @ noise
                rel[b, k] = rng.random() > 0.1
            # an outlier branch: the tag flipped by ~1 rad
            if c >= 1 and b == 1:
                T[b, 0] = T[b, 0] @ exp_np([1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
        # pair (6, 7) is first seen as an outlier only (first in flat order,
        # so the budget keeps it), then good, four times a frame: it rejects
        # them and resets
        if c == 0:
            ids[0] = [6, 7, -1, -1, -1, -1]
            rel[0] = [True, True, False, False, False, False]
            T[0, 0] = lm[6] @ exp_np([0.0, 1.2, 0.0, 0.0, 0.0, 0.0])
            T[0, 1] = lm[7]
        # a padding slot whose PnP pose is NaN, as for an invalid detection
        T[2, D - 1] = np.nan
        out.append((ids, T.astype(np.float32), rel))
    return out


@pytest.fixture(scope="module")
def accumulated():
    states = []
    with jax.enable_x64(False):
        tg = JT.taggraph_init(M)
        states.append(np_state(tg))
        for ids, T, rel in chunks():
            tg = JT.taggraph_accumulate(tg, jnp.asarray(ids), jnp.asarray(T), jnp.asarray(rel),
                                        compact_budget=16)
            states.append(np_state(tg))
    return states


def assert_tg(got, want):
    np.testing.assert_array_equal(got.count.numpy(), want["count"])
    np.testing.assert_array_equal(got.rejected.numpy(), want["rejected"])
    g = {f.name: getattr(got, f.name).numpy() for f in dataclasses.fields(got)}
    have = want["count"] > 0
    np.testing.assert_allclose(means(g)[have], means(want)[have], atol=1e-4)


def test_accumulate(accumulated):
    states = accumulated
    final = states[-1]
    assert final["count"].sum() > 0 and final["rejected"].sum() > 0
    # overflow: more valid pairs in a chunk than the budget of 16
    ids0, _, rel0 = chunks()[1]
    n_valid = sum(int(((ids0[b][:, None] < ids0[b][None]) & (ids0[b][:, None] >= 0)
                       & rel0[b][:, None] & rel0[b][None]).sum()) for b in range(B))
    assert n_valid > 16
    for c, (ids, T, rel) in enumerate(chunks()):
        got = TS.taggraph_accumulate(to_port(states[c]), torch.as_tensor(ids), torch.as_tensor(T),
                                     torch.as_tensor(rel), compact_budget=16)
        assert_tg(got, states[c + 1])
    # the pair whose reference was an outlier reset (count and rejections
    # cleared) and was re-elected later
    c67 = [s["count"][6, 7] for s in states]
    assert c67[1] == 1 and any(a > 0 and b == 0 for a, b in zip(c67, c67[1:])), c67


def test_accumulate_single_frame_and_no_budget(accumulated):
    ids, T, rel = chunks()[2]
    with jax.enable_x64(False):
        j1 = np_state(JT.taggraph_accumulate(JT.taggraph_init(M), jnp.asarray(ids[0]), jnp.asarray(T[0]),
                                             jnp.asarray(rel[0])))
        j2 = np_state(JT.taggraph_accumulate(JT.taggraph_init(M), jnp.asarray(ids), jnp.asarray(T),
                                             jnp.asarray(rel), compact_budget=0))
    t0 = TS.taggraph_init(M, device="cpu")
    assert_tg(TS.taggraph_accumulate(t0, *map(torch.as_tensor, (ids[0], T[0], rel[0]))), j1)
    assert_tg(TS.taggraph_accumulate(t0, *map(torch.as_tensor, (ids, T, rel)), compact_budget=0), j2)


def test_edges_support_and_solve(accumulated):
    st = accumulated[-1]
    rng = np.random.default_rng(5)
    active = np.ones(M, bool)
    active[5] = False
    lm_pose = exp_np(np.concatenate([rng.normal(scale=0.2, size=(M, 3)), rng.normal(scale=8.0, size=(M, 3))], -1))
    hold = np.zeros(M, bool)
    hold[[1, 4]] = True
    with jax.enable_x64(False):
        js = JT.TagGraphState(**{k: jnp.asarray(v) for k, v in st.items()})
        je = JT.taggraph_edges(js, jnp.asarray(active), max_edges=16)
        jsup = np.asarray(JT.taggraph_support(js))
        jnew, jmoved = JT.taggraph_solve(js, jnp.asarray(lm_pose), jnp.asarray(active), jnp.int32(2),
                                         hold=jnp.asarray(hold), iters=4, max_edges=16)
    ts = to_port(st)
    te = TS.taggraph_edges(ts, torch.as_tensor(active), max_edges=16)
    for k in ("i", "j", "ok"):
        np.testing.assert_array_equal(getattr(te, k).numpy(), np.asarray(getattr(je, k)), err_msg=k)
    np.testing.assert_allclose(te.weight.numpy(), np.asarray(je.weight), rtol=1e-6)
    ok = np.asarray(je.ok)
    np.testing.assert_allclose(te.T_meas.numpy()[ok], np.asarray(je.T_meas)[ok], atol=1e-4)
    np.testing.assert_array_equal(TS.taggraph_support(ts).numpy(), jsup)
    tnew, tmoved = TS.taggraph_solve(ts, torch.as_tensor(lm_pose), torch.as_tensor(active),
                                     torch.tensor(2, dtype=torch.int32), hold=torch.as_tensor(hold),
                                     iters=4, max_edges=16)
    assert bool(tmoved) and bool(jmoved)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=1e-4)
    # held and inactive tags stay exactly where they were
    for m in (1, 4, 5):
        assert torch.equal(tnew[m], torch.as_tensor(lm_pose[m])), m


def test_solve_without_anchor_or_edges_is_an_exact_passthrough(accumulated):
    lm_pose = torch.as_tensor(exp_np(np.zeros((M, 6))))
    active = torch.ones(M, dtype=torch.bool)
    for st, anchor in ((to_port(accumulated[-1]), -1), (TS.taggraph_init(M, device="cpu"), 0)):
        new, moved = TS.taggraph_solve(st, lm_pose, active, torch.tensor(anchor, dtype=torch.int32))
        assert not bool(moved)
        assert new is lm_pose


def test_apply_taggraph_gates_and_keyframe_motion(accumulated):
    """The pipeline's landmark solve: a skipped gate (not due, nothing
    movable, no anchor) returns the BA state itself; a solve moves movable
    tags only and each keyframe with its dominant observed movable tag."""
    from dataclasses import replace

    from aprilslam_tpu_torch.slam.pipeline import apply_taggraph

    st = accumulated[-1]
    # Ten times the sightings between tags 2..7: the same pair means, their
    # support past the 24 gate; tags 0 and 1 stay below it and are held.
    k = np.where((np.arange(M)[:, None] >= 2) & (np.arange(M)[None, :] >= 2), 10.0, 1.0).astype(np.float32)
    strong = to_port(dict(st, sum_dev=st["sum_dev"] * k[..., None], count=st["count"] * k,
                          rejected=st["rejected"]))
    rng = np.random.default_rng(8)
    ba = TS.ba_init(4, M, 16, device="cpu")
    lm = torch.as_tensor(exp_np(np.concatenate([rng.normal(scale=0.2, size=(M, 3)),
                                                rng.normal(scale=8.0, size=(M, 3))], -1)))
    obs_lm = torch.tensor([0, 3, 3, 2, 1, 6, 6, 4] + [0] * 8, dtype=torch.int32)
    ba = replace(ba, lm_pose=lm, lm_active=torch.ones(M, dtype=torch.bool), anchor=torch.tensor(0, dtype=torch.int32),
                 kf_active=torch.tensor([True, True, True, False]),
                 kf_pose=torch.as_tensor(exp_np(rng.normal(scale=0.5, size=(4, 6)))),
                 obs_kf=torch.tensor([0, 0, 0, 1, 1, 2, 2, 2] + [0] * 8, dtype=torch.int32), obs_lm=obs_lm,
                 obs_ok=torch.arange(16) < 8)
    yes, no = torch.tensor(True), torch.tensor(False)
    assert apply_taggraph(strong, ba, no, 3) is ba
    assert apply_taggraph(TS.taggraph_init(M, device="cpu"), ba, yes, 3) is ba  # nothing movable
    assert apply_taggraph(strong, replace(ba, anchor=torch.tensor(-1, dtype=torch.int32)), yes, 3).lm_pose is lm
    out = apply_taggraph(strong, ba, yes, 3)
    support = TS.taggraph_support(strong)
    movable = support >= 24
    assert movable.any() and not movable.all()
    moved = (out.lm_pose - lm).abs().amax((1, 2)) > 0
    assert moved.any() and not (moved & ~movable).any()
    # keyframe 3 is inactive and stays; the others move with their
    # dominant movable tag (or not at all if they see none)
    assert torch.equal(out.kf_pose[3], ba.kf_pose[3])
