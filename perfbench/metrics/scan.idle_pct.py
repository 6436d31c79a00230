"""The share of the traced window in which the device idled while the
per-frame scan (``slam.scan`` or a span under it) was the innermost span
open on the host."""

from perfbench.spans import subtree


def read(rec):
    t = rec.get("trace", {})
    if "slam.scan" not in t.get("span_parents", {}):
        return None
    idle = sum(t["span_idle_s"].get(n, 0.0) for n in subtree(t["span_parents"], "slam.scan"))
    return 100.0 * idle / t["window_s"]
