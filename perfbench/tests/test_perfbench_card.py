"""A whole run of a cell on the card: the result line and its keys."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "loop_1k.closure",
                          "--seed", "3147483650", "--seconds", "15", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
        assert {"call_p95_ms", "device.idle_pct", "backend.host_syncs_per_chunk"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"fps", "setup_s"}
