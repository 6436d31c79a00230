"""Landmark pose-graph solves per chunk: calls of ``slam.taggraph.solve``,
which opens only when the solve's gate passes, over the chunks of the pass
under the program's span recorder."""


def read(rec):
    sp = rec.get("spans", {})
    if "slam.taggraph" not in sp:
        return None
    return sp.get("slam.taggraph.solve", {}).get("calls", 0) / rec["span_calls"]
