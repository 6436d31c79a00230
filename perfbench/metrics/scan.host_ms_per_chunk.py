"""Host time of the per-frame scan (the program's ``slam.scan`` span) per
chunk, from the pass under the program's span recorder."""


def read(rec):
    s = rec.get("spans", {}).get("slam.scan")
    if s is None:
        return None
    return s["host_s"] * 1e3 / rec["span_calls"]
