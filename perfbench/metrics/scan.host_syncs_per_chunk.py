"""Host synchronisations made inside the per-frame scan (``slam.scan`` and
the spans under it) per chunk, from the pass in the span recorder's sync
mode."""

from perfbench.spans import subtree


def read(rec):
    sp = rec.get("spans", {})
    if "slam.scan" not in sp or "span_syncs" not in rec:
        return None
    parents = {n: v["parent"] for n, v in sp.items()}
    return sum(rec["span_syncs"].get(n, 0) for n in subtree(parents, "slam.scan")) / rec["span_calls"]
