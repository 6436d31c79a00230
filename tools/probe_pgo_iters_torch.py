"""LM depth of the chunk-boundary pose-graph solves against the pgo-on
throughput and config-2 accuracy, on the port (port of
``tools/probe_pgo_iters.py``).

The chunk schedule re-solves the camera pose graph and the landmark pose
graph at every chunk boundary, warm-started from the previous solution.
This runs BASELINE config 2 (``bench_torch.pgo_frames``: the randomized
scene, the two-lap loop of 96 frames at 1000x1000, chunks of 8) at graph
capacity 16 with pgo off, then on at ``(pgo_opt_iters, taggraph_iters)``
of (10, 6), (6, 4), (4, 3) and (3, 2): the chunk schedule's defaults of
4/3 (``slam/pipeline.py``) are the JAX package's, "measured ATE-equal" on
a TPU. Each row: a warm pass from a fresh state (its outputs give the ATE,
the JAX probe's ``ate_of``, and the loop edges), then the best of
``--reps`` timed passes, then one pass counting the tensor operations it
dispatches. Prints the JAX probe's lines (with the operations per frame)
and one ``{"pgo_iters": {...}}`` line.

    python3 tools/probe_pgo_iters_torch.py                # on the card; raises without one
    RES=256 python3 tools/probe_pgo_iters_torch.py --device cpu --reps 1
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_pgo_cost_torch import ate_of, config2, device_args, device_header, run_variant  # noqa: E402

# probe_pgo_iters.py:112: (pgo_opt_iters, taggraph_iters) per pgo-on row.
DEPTHS = ((10, 6), (6, 4), (4, 3), (3, 2))
BATCH = 8  # probe_pgo_iters.py:39


def iters_row(cfg, cam, traj, chunks, params, dev, pgo: bool, oi: int = 10, ti: int = 6, reps: int = 2,
              **step_kw) -> dict:
    """The JAX probe's ``run(pgo, oi, ti)``: graph capacity 16, the given
    depths (and ``step_kw``); ``run_variant``'s row plus ``ate``."""
    r = run_variant(cfg, cam, chunks, params, dev, pgo, None, reps, graph_capacity=16, pgo_opt_iters=oi,
                    taggraph_iters=ti, **step_kw)
    r["ate"] = ate_of(cfg, traj, r["outputs"])
    return r


def main(argv=None) -> int:
    from bench_torch import headline_params

    args, dev = device_args(__doc__.split("\n\n")[0], argv, reps=2)
    head = device_header(dev)
    res = int(os.environ.get("RES", "1000"))
    cfg, cam, traj, chunks = config2(dev, res, BATCH)
    params = headline_params()
    off = iters_row(cfg, cam, traj, chunks, params, dev, False, reps=args.reps, count_ops=True)
    print(f"off            {off['fps']:6.1f} fps  ate {off['ate']:.4f}  {off['ops_per_frame']:.0f} ops/frame",
          flush=True)
    rows = {"off": off}
    for oi, ti in DEPTHS:
        r = rows[f"on_oi{oi}_ti{ti}"] = iters_row(cfg, cam, traj, chunks, params, dev, True, oi, ti, args.reps,
                                                  count_ops=True)
        r["ratio"] = r["fps"] / off["fps"]
        print(f"on oi={oi:2d} ti={ti}  {r['fps']:6.1f} fps  ate {r['ate']:.4f}  ratio {r['ratio']:.3f}  "
              f"loops {r['loops']}  {r['ops_per_frame']:.0f} ops/frame", flush=True)
    keep = ("fps", "ms_per_frame", "ate", "ratio", "loops", "ops_per_frame")
    print(json.dumps({"pgo_iters": {**head, "frames": len(traj), "batch": BATCH, "res": res, "reps": args.reps,
                                    "rows": {k: {f: r[f] for f in keep if f in r} for k, r in rows.items()}}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
