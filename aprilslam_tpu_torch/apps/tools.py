"""Small ops tools (port of ``aprilslam_tpu/apps/tools.py``) — parity with
scripts/log_debugging.py and randomize_simulation.py from the reference.

    python -m aprilslam_tpu_torch.apps.tools log data/logs/simulation_runner.log
    python -m aprilslam_tpu_torch.apps.tools randomize --seed 7 -o scene.json
"""

from __future__ import annotations

import argparse
import json
import re
import sys


def pretty_print_log(path: str) -> int:
    """Regex-parse a runner log into readable lines
    (scripts/log_debugging.py:4-27)."""
    pat = re.compile(
        r"^(?P<ts>[\d\-:, ]+)\s+(?P<level>[A-Z]+)\s+(?P<msg>.*)$"
    )
    try:
        with open(path) as f:
            for line in f:
                m = pat.match(line.strip())
                if m:
                    print(f"[{m['level']:>7s}] {m['ts'].strip()} | {m['msg']}")
                elif line.strip():
                    print(f"          | {line.rstrip()}")
    except OSError as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return 2
    return 0


def randomize_config(in_path: str, out_path: str, percentage: float, seed: int | None) -> int:
    """Perturb tag poses by +-percentage -> new config
    (randomize_simulation.py:14-41)."""
    from ..sim import randomize_scene

    with open(in_path) as f:
        raw = json.load(f)
    out = randomize_scene(raw, percentage=percentage, seed=seed)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4)
    print(f"wrote {out_path} (±{percentage * 100:.0f}% perturbation)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aprilslam ops tools (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    lg = sub.add_parser("log", help="pretty-print a runner log")
    lg.add_argument("path", nargs="?", default="data/logs/simulation_runner.log")

    rz = sub.add_parser("randomize", help="randomize a scene config")
    rz.add_argument("--config", "-c", default=None)
    rz.add_argument("--output", "-o", default=None)
    rz.add_argument("--percentage", "-p", type=float, default=0.1)
    rz.add_argument("--seed", type=int, default=None)

    args = p.parse_args(argv)
    if args.cmd == "log":
        return pretty_print_log(args.path)
    from ..sim.config import DEFAULT_SCENE

    in_path = args.config or DEFAULT_SCENE
    out_path = args.output or "scene_randomized.json"
    return randomize_config(in_path, out_path, args.percentage, args.seed)


if __name__ == "__main__":
    sys.exit(main())
