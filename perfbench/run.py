"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``aprilslam_tpu_torch``).
Set-up (imports, the CCL library's build or load, rendering the cell's
frame pool on the card, building the program, warming every shape the
traffic uses) is timed as ``setup_s``; then the window runs for
``--seconds``, untraced. ``--trace 1`` reads the per-layer metrics from a
few more calls after the window. The last line of standard output is one
JSON object; the numbers compared with their limits are the last lines of
standard error. Without a CUDA card, or with fewer than the cell asks for,
it exits 2 and prints no result; if the JAX stack, the JAX package or
another of the repo's harnesses is loaded once the window has closed, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build or kernel cache stays inside the checkout, at a fixed path.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, _state = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                      T_START, log=lambda s: print(s, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
