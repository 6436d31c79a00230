"""Sweep the frames per call of a front-end traffic mix on the card, with a
traced reading at each size: the sweep that fixed ``tagpose_fleet``'s F
(PERF.md).

    python3 perfbench/sweep.py --config sim_default_1k --traffic tagpose_fleet --frames 64,128,256,512 --seconds 20

One JSON line per size and round: fps and the 95th percentile of call
latency over the untraced window, the device's idle share over the traced
calls, peak memory, and ``correct``. The benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--frames", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.reduce import idle_pct, percentile

    if not torch.cuda.is_available():
        print("perfbench sweep: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for r in range(args.rounds):
        for F in (int(x) for x in args.frames.split(",")):
            cell = {"name": f"{args.config}.{args.traffic}", "config": args.config, "traffic": args.traffic,
                    "chips": 1}
            res, st = harness.run_cell(cell, args.seed + r, args.seconds, True, device,
                                       time.perf_counter(), overrides={"frames_per_call": F},
                                       log=lambda s: None)
            rec = st["rec"]
            line = {"round": r, "frames_per_call": F, "fps": rec["frames"] / rec["window_s"],
                    "call_p95_ms": percentile(rec["calls_s"], 95) * 1e3, "calls": len(rec["calls_s"]),
                    "idle_pct": idle_pct(rec["trace"]["busy_s"], rec["trace"]["window_s"]),
                    "memory_peak_bytes": res["device"]["memory_peak_bytes"], "setup_s": rec["setup_s"],
                    "correct": res["correct"], "per_layer": {k: v["value"] for k, v in res["metrics"].items()},
                    "checks": {k: v["value"] for k, v in res["checks"].items()}}
            print(json.dumps(line), flush=True)
            del st
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
