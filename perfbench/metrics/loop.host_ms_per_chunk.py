"""Host time of loop closure at the chunk boundary per chunk: the camera
pose-graph solve (``slam.pgo_solve``, when loop edges are pending) and the
landmark pose graph (``slam.taggraph``), from the pass under the program's
span recorder."""


def read(rec):
    sp = rec.get("spans", {})
    if "slam.taggraph" not in sp:
        return None
    host = sp["slam.taggraph"]["host_s"] + sp.get("slam.pgo_solve", {}).get("host_s", 0.0)
    return host * 1e3 / rec["span_calls"]
