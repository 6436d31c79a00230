"""Does the quads stage's cost per frame grow with batch on this device?
(port of ``tools/probe_quads_batch.py``, which found it growing on a TPU).

For B = 8 and 32: ``monte_carlo(B, seed=3)`` of the default scene at RES x
RES through the detector's threshold and the CCL kernel
(``tools/probe_quads_torch.py``'s ``maps``), then nested prefixes of
``quad_candidates`` timed on those maps: emit, emit+compact, +cluster,
full quads. Per prefix: the JAX tool's wall ms per call (REPS calls
enqueued, one synchronize) and per frame, and the kernel ms per call from
``torch.profiler`` (on the card). Prints the JAX tool's lines and one
``{"quads_batch": {...}}`` line.

    python3 tools/probe_quads_batch_torch.py              # on the card; raises without one
    RES=384 REPS=3 python3 tools/probe_quads_batch_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_quads_torch import kernel_ms, maps, quads_kwargs  # noqa: E402

from aprilslam_tpu_torch.detect import DetectorParams  # noqa: E402
from aprilslam_tpu_torch.detect import quads as Q  # noqa: E402

PARAMS = DetectorParams(quad_decimate=2, min_cluster_pts=12, max_detections=16)  # probe_quads_batch.py:30
BATCHES = (8, 32)


def prefixes(p: DetectorParams = PARAMS) -> dict:
    """name: f(trinary, labels, dec, level) for each nested prefix, as the
    JAX tool's (its full prefix returns the corners)."""
    def emit(t, lab, g, lv):
        return Q._emit_boundaries(t, lab, g, lv)

    def emit_compact(t, lab, g, lv):
        return Q._compact(*emit(t, lab, g, lv), p.max_boundary)

    def emit_compact_cluster(t, lab, g, lv):
        return Q._cluster(*emit_compact(t, lab, g, lv), p.max_clusters, p.min_cluster_pts)

    def full(t, lab, g, lv):
        return Q.quad_candidates(t, lab, g, p.quad_decimate, lv, **quads_kwargs(p)).corners

    return {"emit": emit, "emit+compact": emit_compact, "+cluster": emit_compact_cluster, "full quads": full}


def enqueued_ms(fn, args, dev, reps: int) -> float:
    """The JAX tool's reading: one warm call, then ``reps`` calls enqueued
    and one synchronize; mean ms per call."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def run(dev, res: int, reps: int, batches=BATCHES) -> dict:
    """Per batch: each prefix's wall and kernel ms per call and per frame,
    and (not in the JSON line) the maps and each prefix's last output."""
    dev = torch.device(dev)
    out = {}
    for B in batches:
        m = maps(B, res, dev, PARAMS)
        args = (m["trinary"], m["labels"], m["dec"], m["level"])
        rows, outputs = {}, {}
        for name, fn in prefixes().items():
            ms = enqueued_ms(fn, args, dev, reps)
            k = kernel_ms(fn, args, dev, reps)
            rows[name] = {"ms": ms, "ms_per_frame": ms / B, "kernel_ms": k,
                          "kernel_ms_per_frame": None if k is None else k / B}
            outputs[name] = fn(*args)
        out[B] = {"rows": rows, "maps": m, "outputs": outputs}
    return out


def print_rows(B: int, rows: dict) -> None:
    print(f"B={B}:")
    for name, r in rows.items():
        k = r["kernel_ms"]
        print(f"  {name:14s} {r['ms']:8.2f} ms/call  {r['ms_per_frame']:6.3f} ms/frame  kernel "
              + ("not measured" if k is None else f"{k:.3f} ms/call {r['kernel_ms_per_frame']:.4f} ms/frame"),
              flush=True)


def main(argv=None) -> int:
    from aprilslam_tpu_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    on_cuda = dev.type == "cuda"
    print("device:", torch.cuda.get_device_name(dev) if on_cuda else "cpu", file=sys.stderr, flush=True)
    res, reps = int(os.environ.get("RES", "1000")), int(os.environ.get("REPS", "20"))
    r = run(dev, res, reps)
    for B, b in r.items():
        print_rows(B, b["rows"])
    print(json.dumps({"quads_batch": {"res": res, "reps": reps, "by_batch": {str(B): b["rows"] for B, b in r.items()},
                                      "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
                                      "card": card_line() if on_cuda else None}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
