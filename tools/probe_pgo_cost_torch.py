"""Where the loop-closure back end's throughput cost lives, on the port (port
of ``tools/probe_pgo_cost.py``).

Times BASELINE config 2's chunk step (``bench_torch.pgo_frames``: the
randomized scene, the two-lap loop of 96 frames, chunks of ``B``) under
ablations, set on ``aprilslam_tpu_torch.slam.pipeline``'s module globals
and restored afterwards:

  off            pgo=False
  on             the full production path
  no_tgsolve     taggraph_solve stubbed to identity
  no_tgacc       taggraph_accumulate stubbed (state passthrough)
  no_chunk_end   both taggraph functions and pgo_solve stubbed (the scan's cost only)

then ``on_cap16``/``off_cap16`` (graph capacity 16, the scene's 5 tags),
then three rows with the JAX probe's ATE: ``off_cap16``, ``on_cap16_it6``
and ``on_cap16_it4``. Each row: one warm pass from a fresh state (the ATE
rows' outputs), then the best of ``--reps`` timed passes, each ending in a
synchronize, then one more pass that counts the tensor operations
dispatched (``ops_per_frame``: the step is host-bound, so its time follows
its operations, and the count does not vary between runs). With
``--rounds R`` the first seven rows are then timed again, one pass each in
turn for R rounds (best and median per row), so that a change of host
speed during the run falls on every row alike. Prints the JAX probe's
lines, the split by operations (and by the rounds' time) and one
``{"pgo_cost": {...}}`` line.

    python3 tools/probe_pgo_cost_torch.py                 # on the card; raises without one
    python3 tools/probe_pgo_cost_torch.py --rounds 8
    B=8 RES=256 python3 tools/probe_pgo_cost_torch.py --device cpu --reps 1

As in the JAX probe, the ATE rows wrap ``taggraph_solve`` in
``partial(..., iters=it)`` (``probe_pgo_cost.py:180``); the pipeline passes
``iters=taggraph_iters`` at the call, which overrides the partial's, so
``on_cap16_it6`` and ``on_cap16_it4`` run the same step. The JSON line
says whether their outputs are equal.

``run_variant``, ``ate_of`` and the stubs are shared with
``tools/probe_pgo_iters_torch.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import aprilslam_tpu_torch.slam.pipeline as pipemod  # noqa: E402

# probe_pgo_cost.py:105-108: the config-2 chunk step the probe times.
STEP = dict(estimator="ba", ba_schedule="chunk", init_joint_iters=3, ba_chunk_iters=4, pnp_iters=3)
ORIG = dict(taggraph_solve=pipemod.taggraph_solve, taggraph_accumulate=pipemod.taggraph_accumulate,
            pgo_solve=pipemod.pgo_solve)


def _false(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=like.device)


def stub_tgsolve(tg, lm_pose, lm_active, anchor, hold=None, **kw):
    return lm_pose, _false(lm_pose)


def stub_tgacc(tg, ids, T_obs, reliable, **kw):
    return tg


def stub_pgosolve(pgo, opt_iters=10):
    P = pgo.n_nodes_capacity
    eye = torch.eye(4, dtype=pgo.node_pose.dtype, device=pgo.node_pose.device).expand(P, 4, 4)
    return pgo, eye, _false(pgo.node_pose)


# name: (pgo, the pipeline globals it replaces)
VARIANTS = {
    "off": (False, {}),
    "on": (True, {}),
    "no_tgsolve": (True, {"taggraph_solve": stub_tgsolve}),
    "no_tgacc": (True, {"taggraph_accumulate": stub_tgacc}),
    "no_chunk_end": (True, {"taggraph_solve": stub_tgsolve, "taggraph_accumulate": stub_tgacc,
                            "pgo_solve": stub_pgosolve}),
}
STUBBED = ("no_tgsolve", "no_tgacc", "no_chunk_end")
# The ATE rows: (name, graph capacity, the partial's iters, pgo).
ATE_ROWS = (("off_cap16", 16, 6, False), ("on_cap16_it6", 16, 6, True), ("on_cap16_it4", 16, 4, True))
SAME_STEP_NOTE = ("taggraph_solve is wrapped in partial(iters=it) as probe_pgo_cost.py:180 does; the pipeline "
                  "calls it with iters=taggraph_iters, which overrides the partial's, so on_cap16_it6 and "
                  "on_cap16_it4 run the same step")


def iters_patch(it: int) -> dict:
    """The JAX probe's ATE-row patch: ``taggraph_solve`` with ``iters=it``
    bound by ``partial`` (a no-op: see the module's docstring)."""
    return {"taggraph_solve": functools.partial(ORIG["taggraph_solve"], iters=it)}


@contextlib.contextmanager
def patched(patches: dict):
    """Set ``patches`` on the pipeline module; restore the originals on exit."""
    saved = {k: getattr(pipemod, k) for k in patches}
    try:
        for k, v in patches.items():
            setattr(pipemod, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(pipemod, k, v)


def config2(dev, res: int = 1000, batch: int = 8) -> tuple:
    """Config 2's scene config, camera, trajectory and chunks on ``dev``:
    ``bench_torch.pgo_frames`` (rendered on the device, cached)."""
    from bench_torch import pgo_frames

    from aprilslam_tpu_torch.sim import DEFAULT_SCENE

    with open(DEFAULT_SCENE) as f:
        return pgo_frames(json.load(f), res, batch, dev)


class OpCount(TorchDispatchMode):
    """Counts the tensor operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def one_pass(row: dict, chunks) -> tuple[list, float]:
    """One pass of ``row``'s step over ``chunks`` from its state, with its
    patches on the pipeline, ending in a synchronize; ``row["state"]``
    moves on. Returns (the outputs, one per chunk; seconds)."""
    dev = row["device"]
    with patched(row["patches"]):
        t0, outs = time.perf_counter(), []
        for c in chunks:
            row["state"], o = row["step"](row["state"], c)
            outs.append(o)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0


def run_variant(cfg, cam, chunks, params, dev, pgo: bool, patches=None, reps: int = 3, count_ops: bool = False,
                **step_kw) -> dict:
    """One row: the step (``STEP``, ``pgo``, ``step_kw``) built with
    ``patches`` on the pipeline, a warm pass over ``chunks`` from a fresh
    state, then the best of ``reps`` timed passes (``one_pass``), then, with
    ``count_ops``, one pass under ``OpCount``. Returns fps, ms per frame, the
    best pass's seconds (None at ``reps=0``: the warm pass alone), the warm
    pass's seconds (``first_s``) and outputs (one ``SlamOutputs`` per
    chunk), its loop edges, the operations per frame (or None), and what
    ``one_pass`` needs to go on."""
    from aprilslam_tpu_torch.slam import build_slam_step

    row = {"device": torch.device(dev), "patches": patches or {}}
    with patched(row["patches"]):
        row["step"], init = build_slam_step(cfg.family, cam, cfg.tag_size_inner, detector_params=params,
                                            device=row["device"], pgo=pgo, **{**STEP, **step_kw})
    row["state"] = init()
    outs, first_s = one_pass(row, chunks)
    times = [one_pass(row, chunks)[1] for _ in range(reps)]
    n, best = sum(len(c) for c in chunks), min(times, default=None)
    ops = None
    if count_ops:
        with OpCount() as counter:
            one_pass(row, chunks)
        ops = counter.n / n
    return {**row, "fps": best and n / best, "ms_per_frame": best and 1e3 * best / n, "s": best, "first_s": first_s,
            "outputs": outs, "loops": int(outs[-1].loop_closures[-1]) if pgo else 0, "ops_per_frame": ops}


def interleave(rows: dict, chunks, rounds: int) -> dict:
    """``rounds`` rounds of one timed pass of each row in turn; per row the
    best and the median fps over the rounds."""
    n = sum(len(c) for c in chunks)
    times = {name: [] for name in rows}
    for _ in range(rounds):
        for name, row in rows.items():
            times[name].append(one_pass(row, chunks)[1])
    return {name: {"fps_best": n / min(t), "fps_median": n / float(np.median(t))} for name, t in times.items()}


def ate_of(cfg, traj, outs) -> float:
    """The JAX probes' ``ate_of`` (``probe_pgo_iters.py:77-85``): translation
    RMSE over the frames that are valid and reported in a scene tag's frame
    (``probe_ate_dist_torch``'s ``frame_errors``, the same arithmetic)."""
    from probe_ate_dist_torch import frame_errors, rmse

    o = {k: np.concatenate([getattr(x, k).cpu().numpy() for x in outs]) for k in ("poses", "valid", "coord_id")}
    err, scored, _gt = frame_errors(cfg, traj, o)
    return rmse(err, scored)


def same_outputs(a, b) -> bool:
    """Two runs' outputs (lists of ``SlamOutputs``) equal field by field."""
    return all(torch.equal(getattr(x, f), getattr(y, f)) for x, y in zip(a, b) for f in vars(x))


def recovers(fps: dict) -> dict:
    """Each stub's share of the on/off fps gap that it recovers, in %."""
    off, on = fps["off"], fps["on"]
    return {name: (fps[name] - on) / max(off - on, 1e-9) * 100 for name in STUBBED if name in fps}


def removes(ops: dict) -> dict:
    """Each stub's share of the operations pgo adds per frame that it
    takes away, in %."""
    off, on = ops["off"], ops["on"]
    return {name: (on - ops[name]) / max(on - off, 1e-9) * 100 for name in STUBBED if name in ops}


def row_line(name: str, r: dict) -> str:
    ops = "" if r.get("ops_per_frame") is None else f"   {r['ops_per_frame']:7.0f} ops/frame"
    return f"{name:14s} {r['fps']:7.1f} fps   {r['ms_per_frame']:6.3f} ms/frame{ops}"


def device_header(dev: torch.device) -> dict:
    """The device's name and, on the card, its nvidia-smi line."""
    from aprilslam_tpu_torch.device import card_line

    on_cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    print("device:", name, flush=True)
    return {"device": name, "card": card_line() if on_cuda else None}


def device_args(description: str, argv=None, reps: int = 3, rounds: bool = False):
    """``--device`` (cuda, the default, raises without a GPU), ``--reps``
    (timed passes per row) and, with ``rounds``, ``--rounds``; returns
    (arguments, the device)."""
    from aprilslam_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--reps", type=int, default=reps, help=f"timed passes per row, the best kept (default {reps})")
    if rounds:
        ap.add_argument("--rounds", type=int, default=0,
                        help="then time the first seven rows again in turn, one pass each per round (default 0)")
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)


def main(argv=None) -> int:
    from bench_torch import headline_params

    args, dev = device_args(__doc__.split("\n\n")[0], argv, rounds=True)
    head = device_header(dev)
    B, res = int(os.environ.get("B", "8")), int(os.environ.get("RES", "1000"))
    cfg, cam, traj, chunks = config2(dev, res, B)
    params = headline_params()
    rows = {}
    for name, (pgo, patches) in VARIANTS.items():
        r = rows[name] = run_variant(cfg, cam, chunks, params, dev, pgo, patches, args.reps, count_ops=True)
        print(row_line(name, r), flush=True)
    fps = {k: r["fps"] for k, r in rows.items()}
    print(f"\npgo_on/pgo_off = {fps['on'] / fps['off']:.3f}")
    rec = recovers(fps)
    for name, pct in rec.items():
        print(f"{name}: recovers {pct:.0f}% of the gap")
    by_ops = removes({k: r["ops_per_frame"] for k, r in rows.items()})
    print("by operations: " + ", ".join(f"{name} removes {pct:.0f}%" for name, pct in by_ops.items())
          + " of what pgo adds")

    for name in ("on_cap16", "off_cap16"):
        r = rows[name] = run_variant(cfg, cam, chunks, params, dev, name.startswith("on"), None, args.reps,
                                     count_ops=True, graph_capacity=16)
        print(row_line(name, r), flush=True)

    ate_rows = {}
    for name, cap, it, pgo in ATE_ROWS:
        r = ate_rows[name] = run_variant(cfg, cam, chunks, params, dev, pgo, iters_patch(it), args.reps,
                                         graph_capacity=cap)
        r["ate"] = ate_of(cfg, traj, r["outputs"])
        print(f"{row_line(name, r)}   ate {r['ate']:.4f}", flush=True)

    rounds = interleave(rows, chunks, args.rounds) if args.rounds else {}
    for name, r in rounds.items():
        print(f"{name:14s} {r['fps_best']:7.1f} fps best, {r['fps_median']:7.1f} median of {args.rounds} rounds")
    rec_rounds = recovers({k: r["fps_median"] for k, r in rounds.items()}) if rounds else {}
    for name, pct in rec_rounds.items():
        print(f"{name}: recovers {pct:.0f}% of the gap (median of the rounds)")

    keep = ("fps", "ms_per_frame", "loops", "ate", "ops_per_frame")
    line = {**head, "frames": len(traj), "batch": B, "res": res, "reps": args.reps, "rounds": args.rounds,
            "rows": {k: {f: r[f] for f in keep if f in r} for k, r in rows.items()},
            "ate_rows": {k: {f: r[f] for f in keep if f in r} for k, r in ate_rows.items()},
            "pgo_on_over_off": fps["on"] / fps["off"], "recovers_pct": rec, "removes_ops_pct": by_ops,
            "rounds_fps": rounds, "recovers_pct_rounds": rec_rounds,
            "it6_it4_equal_outputs": same_outputs(ate_rows["on_cap16_it6"]["outputs"],
                                                  ate_rows["on_cap16_it4"]["outputs"]),
            "it6_it4_note": SAME_STEP_NOTE}
    print(json.dumps({"pgo_cost": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
