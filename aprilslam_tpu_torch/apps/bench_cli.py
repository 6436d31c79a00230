"""Benchmark CLI (port of ``aprilslam_tpu/apps/bench_cli.py``): maps its
flags onto the environment knobs of ``bench_torch.py`` and runs that file
from the working directory (the root of the repo).

Like the JAX CLI, ``--batch`` always sets BENCH_BATCH, so the batch is
pinned and the bench's sweep does not run; ``--chunks`` sets BENCH_CHUNKS,
which no bench reads.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aprilslam_tpu_torch benchmark")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="execution device (cuda, the default, is an error without a GPU)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resolution", type=int, default=1000)
    p.add_argument("--chunks", type=int, default=6,
                   help="accepted for the JAX CLI's sake; no effect (no bench reads BENCH_CHUNKS)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    os.environ["BENCH_BATCH"] = str(args.batch)
    os.environ["BENCH_RES"] = str(args.resolution)
    os.environ["BENCH_CHUNKS"] = str(args.chunks)
    if args.cpu or args.device == "cpu":
        os.environ["BENCH_DEVICE"] = "cpu"
    bench_path = os.path.join(os.getcwd(), "bench_torch.py")
    if not os.path.exists(bench_path):
        print("bench_torch.py not found in cwd", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("bench_torch", bench_path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.main()


if __name__ == "__main__":
    sys.exit(main())
