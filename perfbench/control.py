"""Read the comparison's numbers on many seeds: the program's, the
control's (the reference computed in bfloat16 in the program's place) and,
where asked, the program's with a fault planted in its answers. The limits
in ``reference/limits.json`` are set from these readings (PERF.md).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 40 [--faults half_batch --fault-seeds 1]
    python3 perfbench/control.py --config <config> --traffic <mix> --seeds 1 --seconds 5

(the second form for a cell that ``BENCHMARK.json`` does not list).

One process reads every seed, at the cell's own size and load. One JSON
line per seed goes to standard output. The benchmark's runs never run this.
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


def readings(workload, seed: int, seconds: float, faults, device, overrides=None, t_start=None) -> dict:
    """The program's, the control's and each fault's numbers on one seed
    (``workload``: a cell's name, or the cell itself; see ``harness.run_cell``)."""
    from perfbench import harness

    t0 = time.perf_counter() if t_start is None else t_start
    result, st = harness.run_cell(workload, seed, seconds, False, device, t0, overrides=overrides,
                                  log=lambda s: None)
    lim = harness.limits()
    ctrl = harness.judge_window(st["cfg"], st["trf"], st["inputs"], st["caller"], st["window"], seed,
                                control=lim["control_dtype"])
    out = {"seed": seed, "correct": result["correct"], "program": st["nums"], "control": ctrl,
           "control_correct": all(harness.holds(c) for c in harness.checks(st["cfg"], ctrl).values()),
           "fps": result["metrics"].get("fps", {}).get("value"), "faults": {}}
    del st
    for f in faults:
        r, stf = harness.run_cell(workload, seed, min(seconds, 10.0), False, device, time.perf_counter(),
                                  fault=f, overrides=overrides, log=lambda s: None)
        out["faults"][f] = {"correct": r["correct"], "nums": stf["nums"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=None, help="plant the faults on the first N seeds only")
    args = ap.parse_args(argv)
    cell = args.workload or {"name": f"{args.config}.{args.traffic}", "config": args.config,
                             "traffic": args.traffic, "chips": 1}

    import torch

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    faults = [f for f in args.faults.split(",") if f]
    for i, s in enumerate(args.seeds.split(",")):
        planted = faults if args.fault_seeds is None or i < args.fault_seeds else []
        r = readings(cell, int(s), args.seconds, planted, device, t_start=T_START if i == 0 else None)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
